"""The kernel wrappers and DTensors.  Each of the six wrappers reads raw
pointers, so it takes local tensors only: on a ``DTensor`` argument it
raises ``TypeError`` before any launch, whichever argument it is and on
whichever device (the sharded model calls the kernels on each rank's
local tensors).  The same local tensors run as before."""

import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels import ops
from test_torch_autograd_guard import _outputs, guard_cases
from torch_mesh_workers import world1  # noqa: F401  (a fixture)


@pytest.mark.parametrize("case", range(6))
def test_wrapper_raises_on_a_dtensor_before_any_launch(world1, case):
    name, fn, inputs = guard_cases("cpu")[case]
    ops.reset_launches()
    for i in range(len(inputs)):
        args = [DTensor.from_local(t, world1, [Replicate(), Replicate()])
                if j == i else t for j, t in enumerate(inputs)]
        with pytest.raises(TypeError, match=f"{name}: a DTensor"):
            fn(*args)
    assert sum(ops.LAUNCHES.values()) == 0
    out = _outputs(fn(*inputs))          # the local tensors: the plain path
    assert all(not isinstance(t, DTensor) and bool(torch.isfinite(t).all())
               for t in out)
