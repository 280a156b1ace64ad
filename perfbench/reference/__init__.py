"""The benchmark's plain reference: plain PyTorch in float32 with TF32 off,
importing nothing of the program."""
