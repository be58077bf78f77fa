"""semi_supervised_asr_tpu_torch: the PyTorch / CUDA port of the recognizer.

The JAX package ``semi_supervised_asr_tpu`` stays the reference.  This
package runs the LAS serving path on one NVIDIA H100:

    raw audio -> framing + DFT (torch) -> fused post-FFT frontend (CUDA
    kernel, csrc/fused_post_fft.cu) -> pyramidal BiLSTM listener (CUDA
    LSTM scan kernel, csrc/lstm_scan_fwd.cu) -> location-aware attention
    LSTM speller (torch) -> greedy or batched beam decode (torch)

Host-side modules (config, vocab, bucketing, audio loading, the numpy
frontend oracle) are imported from the JAX package; none of them imports
JAX.  Kernels are built by ``nvcc`` at first use (``_native.py``), so the
package imports on a machine without CUDA, where every kernel wrapper runs
its plain PyTorch version for CPU tensors.
"""

import torch

__version__ = "0.1.0"


def strict_fp32() -> None:
    """Turn TF32 off for float32 matmuls and convolutions.

    The reference runs its float32 products at full precision (the matmul
    DFT at ``Precision.HIGHEST``); TF32 keeps ~3 decimal digits, far
    outside the port's 1e-5 parity tolerances.  cuDNN convolutions (the
    attention's location conv) default to TF32, so entry points call this.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
