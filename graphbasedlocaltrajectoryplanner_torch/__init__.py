"""PyTorch/CUDA port of the graph-based local trajectory planner.

Counterpart of ``graphbasedlocaltrajectoryplanner_tpu`` (the JAX package,
which stays the reference): the same module names and paths, written as
plain PyTorch on tensors with a written-out batch dimension, with every
Pallas kernel of the batched fleet tick replaced by a hand-written CUDA
kernel for Hopper (``csrc/``).

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card and without an explicit ``"cpu"`` they raise.
"""

import torch

# full-f32 matmuls everywhere: reduced-precision matmuls move DP argmins
# (the counterpart of graphbasedlocaltrajectoryplanner_tpu/__init__.py)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but none is available")
    return dev


def __getattr__(name):
    # lazy, as the JAX package's: importing the package stays cheap
    if name == "GraphLTPL":
        from graphbasedlocaltrajectoryplanner_torch.planner.facade import (
            GraphLTPL)
        return GraphLTPL
    raise AttributeError(name)
