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
sampling, label-smoothed cross-entropy, global-norm clipping and Adam,
with the recipes' regularization and augmentation (encoder and decoder
dropout, time warp, speed perturbation, additive noise, gradient
accumulation, constant-frames batching) and char, phone or BPE units.
Both entry points also run the transformer and conformer listeners
(``model.encoder_arch``) behind a stride-2 conv stem, whose attention
under ``model.attn_backend: flash`` goes through the CUDA flash attention
kernels (csrc/flash_mhsa_fwd.cu, csrc/flash_mhsa_bwd.cu); the transformer
speller (``model.decoder_arch: transformer``: one parallel causal pass in
training, a KV-cache step in decoding); the joint CTC-attention head
(``objective.lambda_ctc``, ``decode.ctc_weight``, ``decode.ctc_one_pass``,
``--beam 0``); and the encoder-only CTC family (``model.family: ctc``:
the CTC NLL, best-path and prefix-beam decoding); and the RNN-T
transducer family (``model.family: transducer``: the lattice NLL as one
autograd Function with explicit alpha and beta passes, the predictor on
the LSTM scan kernels, greedy and beam decoding, the internal-LM text and
pseudo-label terms), with the forward-only listener
(``model.enc_bidirectional: false``).  Every family trains with MWER
sequence training (``objective.lambda_mwer``: the n-best beam, its
rescoring and on-device edit-distance risks) and the CTC family with its
pseudo-label term; ``transcribe --timestamps`` times tokens by CTC forced
alignment or the greedy walks' emission frames (offline and streaming),
and ``align.py`` forced-aligns a manifest's transcripts.
``data/preprocess.py`` writes the corpus manifests, the vocab and the BPE
model.

The port imports nothing of the JAX package: it keeps its own copies of
the host-side modules (config, vocab, bucketing, the synthetic corpus,
audio loading, the numpy frontend oracle).  Kernels are built by ``nvcc``
at first use (``_native.py``), so the package imports on a machine without
CUDA, where every kernel wrapper runs its plain PyTorch version for CPU
tensors.
"""

import torch

__version__ = "0.3.0"


def strict_fp32() -> None:
    """Turn TF32 off for float32 matmuls and convolutions.

    The reference runs its float32 products at full precision (the matmul
    DFT at ``Precision.HIGHEST``); TF32 keeps ~3 decimal digits, far
    outside the port's 1e-5 parity tolerances.  cuDNN convolutions (the
    attention's location conv, the conv stem) default to TF32, so entry
    points call this.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
