"""PyTorch/CUDA port of the dumpvdl2_tpu VDL Mode 2 receiver.

Runs the device-L2 receive path (wideband IQ -> channelizer -> preamble
sync -> batched L2/RS decode -> device gating and noise floor -> AVLC
frames -> protocol stack -> text/JSON/pp_acars/binary outputs) on an
NVIDIA GPU, device-gated by default and host-gated on request, with the
command line ``python -m dumpvdl2_tpu_torch``.  The preamble sync metric
(``csrc/sync_metric.cu``) and the gate's two per-channel recurrences
(``csrc/gate.cu``) are hand-written CUDA kernels; every other device
stage is plain PyTorch.  The package imports nothing from
``dumpvdl2_tpu``: the host modules it needs are copies kept here.

The receiver's numerics need full float32 products: the channelizer's
im2col matmul leaves its 2e-5 tolerance under TF32, so TF32 is turned
off for matmuls and cuDNN when the package is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
