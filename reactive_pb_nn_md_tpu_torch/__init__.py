"""PyTorch + CUDA port of the reactive MS-EVB molecular dynamics engine.

The JAX package ``reactive_pb_nn_md_tpu`` is the reference this package is
held against.  This package imports ``torch`` and never ``jax``, and
nothing of the JAX package: it keeps its own copies of the input parsers
(``io/``) and unit constants (``utils/constants.py``).  Its entry points
run on the card unless the caller asks for the CPU.

Float32 products run in full float32 on the card: a reduced-precision
``x @ recip_box`` costs about 5% PME force error, so TF32 is switched off
for matmuls and cuDNN when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
