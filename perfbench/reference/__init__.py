"""The plain reference the benchmark holds the port to: CQTDiff+, EDM, the
Heun step, the blind guided step and its filter fit, in float32 PyTorch.
It imports nothing of the port and takes no tensor the port made."""
