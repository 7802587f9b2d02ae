"""The benchmark's plain reference: frozen copies in plain PyTorch and NumPy
of what the measured program computes, used only to judge its outputs.

Nothing here imports the program, the JAX package or JAX. Every function
takes only the benchmark's own inputs (weights, transition matrix, initial
probabilities, audio, logits) and works out again what the program derives
from them. The reference runs in float32 with TF32 off unless a caller asks
for the lower precision of the control (`precision.py`).
"""
