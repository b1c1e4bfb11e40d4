"""The benchmark's plain reference, in plain PyTorch (fdtd.py). It imports
nothing of the program under test."""
