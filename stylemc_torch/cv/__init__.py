"""Host-side face tools: landmark detection (`landmarks.py`) and FFHQ
alignment (`align.py`)."""
