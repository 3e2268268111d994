"""The plain reference of the benchmark's configurations: plain PyTorch,
float32 with TF32 off unless a caller asks for a lower precision (the
control). It imports nothing of the program under test and takes only
the weights and inputs the benchmark made."""
