"""PyTorch/CUDA port of the dumpvdl2_tpu VDL Mode 2 receiver.

Runs the device-L2, host-gated receive path (wideband IQ -> channelizer
-> preamble sync -> batched L2/RS decode -> AVLC frames) on an NVIDIA
GPU.  The preamble sync metric is a hand-written CUDA kernel
(``csrc/sync_metric.cu``); every other device stage is plain PyTorch.
The package imports nothing from ``dumpvdl2_tpu``: the host modules it
needs are copies kept here.

The receiver's numerics need full float32 products: the channelizer's
im2col matmul leaves its 2e-5 tolerance under TF32, so TF32 is turned
off for matmuls and cuDNN when the package is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
