"""The benchmark's yardstick: cells, weights, arithmetic, timing, checks."""
