"""MTCNN face detection: the P/R/O nets (`nets.py`) and the cascade
(`detect.py`)."""
