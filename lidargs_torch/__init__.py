"""lidargs_torch — the PyTorch/CUDA port of lidargs_tpu for one NVIDIA H100.

The same LiDAR range-view Gaussian splatting, module for module beside the
JAX package (which stays the reference): plain tensor code in PyTorch, and
each Pallas kernel of the JAX package as a CUDA kernel written by hand for
Hopper, under `csrc/`, built with nvcc at its first use on a card.

Ported so far: the render path (config, beams and frames, projection,
binning and compositing with kernel K1, the anchor field and its MLP heads,
evaluation metrics, `measure_fps` and `run_eval`), the beam training step
(the hand projection VJP, the backward composite kernel K2, the 5-term loss,
Adam, the densification statistics and `densify_step`), and the surfel
(2DGS) variant's render and training step (`variant="surfel"`: the surfel
preprocess, kernels K5 and K6, the distortion and normal-consistency
terms), the fused-window gather of both (K3/K4, K7/K8), and the data layer
and training CLI (`python -m lidargs_torch.train.cli`: the AlignMiF reader,
the field from the fused point cloud, the chamfer/F-score evaluation,
snapshots, checkpoints and resume, in the JAX package's file formats), and
the offline ray-drop refiner (the frequency-encoding MLP and LiDAR4D's
UNet, `cli refine`), its segmentation losses and the LPIPS metric.

Matrix products stay in full float32 (no TF32), as the JAX package computes
its geometry at `Precision.HIGHEST`.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
