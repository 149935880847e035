"""Seeded random weights for the port's models, drawn on the host with numpy.

No JAX import: the card tests use these too, and the card machine has no
flax. ``seeded_state`` draws every entry of a module's ``state_dict`` as the
parity tests draw flax leaves (kernels at variance 1/fan_in, batch-norm
scales and variances in [0.5, 1.5), biases and means N(0, 0.1)).
"""

from __future__ import annotations

import numpy as np
import torch


def seeded_state(module: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Seeded random values for every entry of ``module``'s ``state_dict`` (a
    conv's fan-in is its input channels per group times its kernel area; a
    transpose conv's, its input channels times its kernel area)."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, value in module.state_dict().items():
        shape, leaf = tuple(value.shape), key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            state[key] = value.clone()
        elif leaf == "weight" and len(shape) == 4:
            fan_in = shape[0] * shape[2] * shape[3] if "conv_transpose" in key else np.prod(shape[1:])
            state[key] = torch.from_numpy(rng.normal(0, np.sqrt(1.0 / fan_in), shape).astype(np.float32))
        elif leaf in ("weight", "running_var"):
            state[key] = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        else:
            state[key] = torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))
    return state


def assert_same_state(got: dict, want: dict) -> None:
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], value), key
