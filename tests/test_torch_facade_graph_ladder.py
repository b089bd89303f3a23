"""PyTorch port, the facade's compiled calls on the CPU into the unclosed
Monteblanco track's end: the drives of ``test_torch_facade_graph.py``
where the handler brakes on its backup path, through the fb ladder
(``brake_on_backup_kernel``, from layer 26) and under the SQP INI through
the SQP ladder (``brake_em_sqp_kernel``, from layer 30), each replayed
from the JAX facade's drive through the port's facade with its steps
captured on the CPU stand-ins and run under the host guard.  Gates: action
keys and node chains equal on every tick, trajectories within 2 mm and
0.02 m/s, every ladder call of the drive (its ``nb`` and ``c_len``
changing) on one graph.  A file of its own so that the long drives share
no worker with the oval's."""

import pytest

from test_torch_facade_graph import compiled, check_drive, tmp  # noqa: F401


@pytest.mark.parametrize("name", ["fb_unclosed", "sqp_unclosed"])
def test_compiled_facade_into_the_track_end(tmp, compiled, name):  # noqa: F811
    check_drive(tmp, compiled, name)
