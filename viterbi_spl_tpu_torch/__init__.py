"""PyTorch/CUDA port of viterbi_spl_tpu: melody extraction by HMM Viterbi
decoding of pitch posteriorgrams, on an NVIDIA Hopper GPU.

The layout mirrors the JAX package (hmm/, io/, metrics/, harness/, cli/,
families.py) so that each module's counterpart is easy to find. The decode
kernels are hand-written CUDA C++ (csrc/), built with nvcc at first use and
bound with ctypes; each has a plain PyTorch version beside it, which a
wrapper runs only for tensors that lie on the CPU.

Entry points run on the GPU unless the caller asks for the CPU
(`device="cpu"`, or `--device cpu` on the command line).
"""

__version__ = "0.1.0"
