"""The functional HoVer-Net checkpoint, built from code (counterpart of
``scripts/make_bench_checkpoints.py:52-160``).

No pannuke weights are in the repository, and random weights give the
watershed no markers. This builds the same hand-set weights as the JAX
package's bench script, a darkness detector routed through the real
architecture, so the post-processing sees real blobs on synthetic slides:

- ``conv0`` channel 0 averages the 7x7 RGB patch and ``bn0`` turns it into
  a nucleus density ``relu(0.70 - mean)``, carried by the 1x1 shortcuts
  through d0..d3; every residual branch is zero;
- each decoder zeroes u3 and u2, so u1 taps the full-resolution density;
  np's logit is ``80 * (density - 0.03)``, hv is ``-8`` times the 3x3 Sobel
  of the density (the ramps of trained hv maps), tp's type-1 logit is
  ``40 * (density - 0.03)``;
- every kernel and BN-scale entry still zero gets noise of magnitude
  ``[2.5e-4, 1e-3]`` with a random sign from ``numpy.random.default_rng(20260820)``,
  drawn leaf by leaf in the flax tree's sorted order (``_densify``), so the
  forward does the full topology's work.

The tree is laid out as the flax module's variables (the order of the
noise depends on it), then converted with ``flax_hovernet_to_torch``;
``tests/test_torch_hovernet.py`` checks it against the script's tree
tensor for tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_hovernet_to_torch

DARKNESS_THRESHOLD = 0.70
NP_GAIN = 80.0
NP_DENSITY_THR = 0.03
HV_GAIN = -8.0
TP_GAIN = 40.0
DENSIFY_EPS = 1e-3
DENSIFY_SEED = 20260820

_STAGES = (("d0", 64, 256, 3), ("d1", 128, 512, 4), ("d2", 256, 1024, 6), ("d3", 512, 2048, 3))


def _conv(params: dict, name: str, k: int, cin: int, cout: int, *, bias: bool = False) -> None:
    params[name] = {"kernel": np.zeros((k, k, cin, cout), np.float32)}
    if bias:
        params[name]["bias"] = np.zeros(cout, np.float32)


def _bn(params: dict, stats: dict, name: str, c: int) -> None:
    params[name] = {"scale": np.zeros(c, np.float32), "bias": np.zeros(c, np.float32)}
    stats[name] = {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}


def _dense(params: dict, stats: dict, name: str, cin: int, k: int, count: int) -> int:
    p, s = params.setdefault(name, {}), stats.setdefault(name, {})
    for u in range(count):
        _bn(p, s, f"u{u}_preact_bn", cin)
        _conv(p, f"u{u}_conv1", 1, cin, 128)
        _bn(p, s, f"u{u}_bn1", 128)
        _conv(p, f"u{u}_conv2", k, 128 // 4, 32)
        cin += 32
    _bn(p, s, "blk_bn", cin)
    return cin


def flax_layout(num_types: int | None, mode: str) -> dict:
    """Zero flax variables of ``HoVerNet(num_types, mode)`` (BN variances 1)."""
    params: dict = {}
    stats: dict = {}
    _conv(params, "conv0", 7, 3, 64)
    _bn(params, stats, "bn0", 64)
    cin = 64
    for stage, mid, out, count in _STAGES:
        p, s = params.setdefault(stage, {}), stats.setdefault(stage, {})
        _conv(p, "shortcut", 1, cin, out)
        for u in range(count):
            if u:
                _bn(p, s, f"u{u}_preact_bn", out)
            _conv(p, f"u{u}_conv1", 1, cin if u == 0 else out, mid)
            _bn(p, s, f"u{u}_bn1", mid)
            _conv(p, f"u{u}_conv2", 3, mid, mid)
            _bn(p, s, f"u{u}_bn2", mid)
            _conv(p, f"u{u}_conv3", 1, mid, out)
        _bn(p, s, "blk_bn", out)
        cin = out
    _conv(params, "conv_bot", 1, 2048, 1024)
    k = 5 if mode == "original" else 3
    branches = [("np", 2), ("hv", 2)]
    if num_types is not None:
        branches.insert(0, ("tp", num_types))
    for branch, out_ch in branches:
        p, s = params.setdefault(branch, {}), stats.setdefault(branch, {})
        _conv(p, "u3_conva", k, 1024, 256)
        _conv(p, "u3_convf", 1, _dense(p, s, "u3_dense", 256, k, 8), 512)
        _conv(p, "u2_conva", k, 512, 128)
        _conv(p, "u2_convf", 1, _dense(p, s, "u2_dense", 128, k, 4), 256)
        _conv(p, "u1_conva", k, 256, 64)
        _bn(p, s, "u0_bn", 64)
        _conv(p, "u0_conv", 1, 64, out_ch, bias=True)
    return {"params": params, "batch_stats": stats}


def _identity_bn(params: dict, stats: dict) -> None:
    params["scale"][:] = 1.0
    params["bias"][:] = 0.0
    stats["mean"][:] = 0.0
    stats["var"][:] = 1.0


def _sorted_leaves(tree: dict, path: tuple = ()):
    """Leaves in ``jax.tree_util``'s order for nested dicts: keys sorted at every level."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _sorted_leaves(tree[key], (*path, key))
        else:
            yield (*path, key), tree[key]


def _densify(variables: dict, eps: float = DENSIFY_EPS) -> None:
    """Replace exact-zero kernel and scale entries with tiny nonzeros, in place."""
    rng = np.random.default_rng(DENSIFY_SEED)
    for path, arr in _sorted_leaves(variables):
        if path[-1] not in ("kernel", "scale"):
            continue
        zeros = arr == 0.0
        n = int(zeros.sum())
        if not n:
            continue
        noise = rng.uniform(eps / 4, eps, size=n).astype(arr.dtype)
        arr[zeros] = noise * rng.choice((-1.0, 1.0), size=n).astype(arr.dtype)


def functional_hovernet_variables(num_types: int | None = 6, mode: str = "fast") -> dict:
    """The functional checkpoint as flax-layout numpy variables."""
    variables = flax_layout(num_types, mode)
    params, stats = variables["params"], variables["batch_stats"]
    k0 = params["conv0"]["kernel"]
    k0[:, :, :, 0] = 1.0 / (k0.shape[0] * k0.shape[1] * 3)
    params["bn0"]["scale"][0] = -1.0
    params["bn0"]["bias"][0] = DARKNESS_THRESHOLD
    for stage, *_ in _STAGES:
        params[stage]["shortcut"]["kernel"][0, 0, 0, 0] = 1.0
        _identity_bn(params[stage]["blk_bn"], stats[stage]["blk_bn"])
    params["conv_bot"]["kernel"][0, 0, 0, 0] = 1.0
    sobel_x = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32) / 8.0
    for branch in ("np", "hv", "tp"):
        if branch not in params:
            continue
        bp, bs = params[branch], stats[branch]
        _identity_bn(bp["u0_bn"], bs["u0_bn"])
        conva = bp["u1_conva"]["kernel"]
        head_k = bp["u0_conv"]["kernel"]
        head_b = bp["u0_conv"]["bias"]
        if branch == "np":
            conva[1, 1, 0, 0] = 1.0
            head_k[0, 0, 0, 1] = NP_GAIN
            head_b[1] = -NP_GAIN * NP_DENSITY_THR
        elif branch == "hv":
            conva[:, :, 0, 0] = HV_GAIN * sobel_x
            conva[:, :, 0, 1] = HV_GAIN * sobel_x.T
            head_k[0, 0, 0, 0] = 1.0
            head_k[0, 0, 1, 1] = 1.0
        else:
            conva[1, 1, 0, 0] = 1.0
            head_k[0, 0, 0, 1] = TP_GAIN
            head_b[1] = -TP_GAIN * NP_DENSITY_THR
    _densify(variables)
    return variables


def functional_hovernet_state_dict(num_types: int | None = 6, mode: str = "fast") -> dict[str, torch.Tensor]:
    """The functional checkpoint as an upstream-named ``state_dict`` for ``HoVerNet``."""
    return flax_hovernet_to_torch(functional_hovernet_variables(num_types, mode))
