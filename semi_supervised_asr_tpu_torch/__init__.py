"""semi_supervised_asr_tpu_torch: the PyTorch / CUDA port of the recognizer.

The JAX package ``semi_supervised_asr_tpu`` stays the reference.  This
package runs, on one NVIDIA H100, the LAS serving path (``transcribe.py``)

    raw audio -> framing + DFT (torch) -> fused post-FFT frontend (CUDA
    kernel, csrc/fused_post_fft.cu) -> pyramidal BiLSTM listener (CUDA
    LSTM scan kernel, csrc/lstm_scan_fwd.cu) -> location-aware attention
    LSTM speller (torch) -> greedy or batched beam decode (torch)

and the supervised LAS train step (``train.py``): the same frontend with
SpecAugment bands, the listener under autograd with its backward scan on
a CUDA kernel (csrc/lstm_scan_bwd.cu), teacher forcing with scheduled
sampling, label-smoothed cross-entropy, global-norm clipping and Adam.

The port imports nothing of the JAX package: it keeps its own copies of
the host-side modules (config, vocab, bucketing, the synthetic corpus,
audio loading, the numpy frontend oracle).  Kernels are built by ``nvcc``
at first use (``_native.py``), so the package imports on a machine without
CUDA, where every kernel wrapper runs its plain PyTorch version for CPU
tensors.
"""

import torch

__version__ = "0.2.0"


def strict_fp32() -> None:
    """Turn TF32 off for float32 matmuls and convolutions.

    The reference runs its float32 products at full precision (the matmul
    DFT at ``Precision.HIGHEST``); TF32 keeps ~3 decimal digits, far
    outside the port's 1e-5 parity tolerances.  cuDNN convolutions (the
    attention's location conv) default to TF32, so entry points call this.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
