"""repro_torch — the PyTorch/CUDA port of the S2M3 reproduction.

Split-and-share multi-task inference (the ``s2m3.Deployment`` facade:
admit, plan, place, route, simulate, serve) with the model, the serving
stack and hand-written Hopper attention kernels in PyTorch.  It mirrors
the JAX package ``repro`` module for module, keeps its parameter
layouts, and imports nothing of it.

Importing the package turns TF32 off for float32 matrix products and
cuDNN convolutions: the port is held to the float32 reference at 2e-4,
which TF32's ~3 decimal digits would not meet.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
