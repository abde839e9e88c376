"""Static tables on the device, uploaded once.

The transmit and decode chains index with tables built in NumPy at
configuration time (scrambling sequences, rate-matching maps, CRC
generator matrices, data-RE indices, DMRS grids, constellations,
precoders). `on_device` turns one into a tensor on a device the first time
it is asked for and hands back the same tensor afterwards, so a
Monte-Carlo loop that runs the chain thousands of times copies each table
from the host once. Callers must not write into a table.
"""

from __future__ import annotations

import torch

_TABLES: dict = {}
# Tables built since import; a test reads it to check that a repeated call
# builds none.
built = 0


def _normal(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def on_device(key, device, make, dtype=None) -> torch.Tensor:
    """The table `make()` (a NumPy array) as a tensor of `dtype` on
    `device`, built at the first call for (key, device, dtype). key must
    identify the table's contents (the configuration it comes from)."""
    global built
    k = (key, _normal(device), dtype)
    table = _TABLES.get(k)
    if table is None:
        table = _TABLES[k] = torch.as_tensor(make(), dtype=dtype,
                                             device=k[1])
        built += 1
    return table
