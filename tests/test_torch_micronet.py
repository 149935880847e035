"""MicroNet, MapDe and SCCNN: the port's networks and weight conversion against flax on the CPU.

Each network runs at the full width of its registry entry (MicroNet and
MapDe on 252x252 patches, SCCNN on 31x31) with seeded random flax
variables (He-normal kernels, random batch-norm terms and biases), built
from ``jax.eval_shape`` without running the flax initialisers, and carried
into the port by ``flax_micronet_to_torch``, ``flax_mapde_to_torch`` and
``flax_sccnn_to_torch``. Going back through JAX's ``torch_*_to_flax`` gives
the flax variables bit for bit (transpose-convolution kernels included).

Tolerances, float32: every output within 1e-4 of its largest magnitude
(the convolutions sum in another order in XLA and in PyTorch's CPU
kernels); MicroNet's ``preproc`` and ``postproc`` equal JAX's exactly, and
so do its instances on both multitask engines with the head in closed form.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiatoolbox_tpu.models.architecture import weight_converter as jax_converter
from tiatoolbox_tpu.models.architecture.mapde import MapDe as JaxMapDe
from tiatoolbox_tpu.models.architecture.micronet import MicroNet as JaxMicroNet
from tiatoolbox_tpu.models.architecture.sccnn import SCCNN as JaxSCCNN
from tiatoolbox_tpu_torch.data.synth import synthetic_he_patch
from tiatoolbox_tpu_torch.models.architecture import get_pretrained_model, load_weights
from tiatoolbox_tpu_torch.models.architecture.mapde import MapDe
from tiatoolbox_tpu_torch.models.architecture.micronet import MicroNet, micronet_forward
from tiatoolbox_tpu_torch.models.architecture.sccnn import SCCNN
from tiatoolbox_tpu_torch.models.architecture.weight_converter import (
    flax_mapde_to_torch,
    flax_micronet_to_torch,
    flax_sccnn_to_torch,
)
from tiatoolbox_tpu_torch.models.models_abc import ModelABC

REL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def random_variables(module, size: int, seed: int, kernel_gain: float = 1.0) -> dict:
    """Seeded flax variables in ``module``'s layout (traced with ``jax.eval_shape``)."""
    tree = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def fill(node: dict) -> dict:
        out = {}
        for key in sorted(node):
            value = node[key]
            if isinstance(value, dict) or hasattr(value, "keys"):
                out[key] = fill(dict(value))
            elif key == "kernel":
                fan_in = int(np.prod(value.shape[:3]))
                std = np.float32(kernel_gain * np.sqrt(2.0 / fan_in))
                out[key] = rng.standard_normal(value.shape, dtype=np.float32) * std
            elif key in ("scale", "var"):
                out[key] = rng.uniform(0.5, 1.5 if key == "var" else 1.0, value.shape).astype(np.float32)
            else:  # bias, mean
                out[key] = rng.normal(0, 0.1, value.shape).astype(np.float32)
        return out

    return fill(dict(tree))


def _close(got: np.ndarray, want: np.ndarray, rel: float = REL_TOL) -> None:
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs diff {err} > {rel} * {scale}"


def _assert_trees_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_equal(got[key], want[key])
        else:
            assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key


def _patches(n: int, size: int, seed: int) -> np.ndarray:
    return np.stack([synthetic_he_patch((size, size), seed=seed + i) for i in range(n)])


@pytest.fixture(scope="module")
def micronet_pair():
    jax_model = JaxMicroNet()
    variables = random_variables(jax_model.module, 252, seed=1)
    port = MicroNet(device="cpu")
    port.load_state_dict(flax_micronet_to_torch(variables))
    return jax_model, variables, port


def test_micronet_conversion_round_trips(micronet_pair) -> None:
    _, variables, port = micronet_pair
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    _assert_trees_equal(jax_converter.torch_micronet_to_flax(state), variables)


def test_micronet_forward_matches_flax(micronet_pair) -> None:
    jax_model, variables, port = micronet_pair
    batch = np.stack([MicroNet.preproc(p) for p in _patches(2, 252, seed=3)])
    want = jax.jit(jax_model.module.apply)(variables, jnp.asarray(batch))
    with torch.inference_mode():
        got = micronet_forward(port.layer, torch.from_numpy(batch).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), np.asarray(w))
    # the engine's entry: the softmax head alone, and a one-head tuple on the host
    head = MicroNet.infer_batch_device(port, batch)
    _close(head.numpy(), np.asarray(want[0]))
    (fetched,) = MicroNet.infer_batch(port, batch)
    np.testing.assert_array_equal(fetched, head.numpy())


def test_micronet_preproc_matches_jax() -> None:
    rng = np.random.default_rng(7)
    for image in (_patches(1, 252, seed=9)[0], np.full((31, 31, 3), 200, np.uint8), rng.integers(0, 256, (5, 7, 3))):
        got = MicroNet.preproc(np.asarray(image, np.uint8))
        want = JaxMicroNet.preproc(np.asarray(image, np.uint8))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _blob_map(shape, seed: int) -> np.ndarray:
    """A two-class softmax-like map with blobs, holes, specks and edge-touching objects."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    field = ndimage.gaussian_filter(rng.random(shape), 3)
    fg = field > np.quantile(field, 0.7)
    fg[5:9, 5:9] = True  # a speck under 50 pixels
    fg[40:60, 40:60] = True
    fg[47:52, 47:52] = False  # a hole
    p1 = np.where(fg, 0.8, 0.2).astype(np.float32)
    return np.stack([1 - p1, p1], axis=-1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_micronet_postproc_matches_jax(seed: int) -> None:
    raw = _blob_map((200, 180), seed)
    offset = (13, 7) if seed else (0, 0)
    port = MicroNet.__new__(MicroNet)
    port.tasks = ["nuclei_segmentation"]
    jax_model = JaxMicroNet.__new__(JaxMicroNet)
    jax_model.tasks = ["nuclei_segmentation"]
    (got,) = MicroNet.postproc(port, [raw], offset=offset)
    (want,) = JaxMicroNet.postproc(jax_model, [raw], offset=offset)
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
    assert got["seg_type"] == want["seg_type"] and got["task_type"] == want["task_type"]
    assert len(got["info_dict"]["box"]) == len(want["info_dict"]["box"]) > 3
    for key in ("box", "centroid", "contours", "prob", "type"):
        for g, w in zip(got["info_dict"][key], want["info_dict"][key]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=key)


def test_mapde_forward_matches_flax(monkeypatch) -> None:
    from tiatoolbox_tpu_torch.models.architecture import weight_converter

    jax_model = JaxMapDe(num_classes=1)
    variables = random_variables(jax_model.module, 252, seed=2)
    state = flax_mapde_to_torch(variables)
    assert "dist_filter" not in state and all(k.startswith("layer.") for k in state)
    state_np = {k: v.numpy() for k, v in state.items()}
    _assert_trees_equal(jax_converter.torch_mapde_to_flax({**state_np, "dist_filter": 0}), variables)
    batch = _patches(1, 252, seed=5)
    want = np.asarray(jax.jit(jax_model.module.apply)(variables, jnp.asarray(batch, jnp.float32)))
    # through the registry and a flax .npz (its reader stubbed: the file would
    # hold 737 MB), as a user loads converted weights
    monkeypatch.setattr(weight_converter, "load_flax_npz", lambda path: variables)
    port, _ = get_pretrained_model("mapde-conic", pretrained_weights="mapde.npz", device="cpu")
    assert isinstance(port, MapDe) and port.min_distance == 3 and port.threshold_abs == 205
    got = MapDe.infer_batch(port, batch)  # raw 0-255 values: no /255
    _close(got, want)
    # a reference .pth carries the cone as a buffer: it is dropped on load
    with torch.no_grad():
        for p in port.parameters():
            p.zero_()
    monkeypatch.setattr(torch, "load", lambda *a, **k: {**state, "dist_filter": torch.zeros(1, 2, 11, 11)})
    load_weights(port, "mapde.pth")
    np.testing.assert_array_equal(MapDe.infer_batch(port, batch), got)


def test_sccnn_forward_matches_flax(tmp_path) -> None:
    jax_model = JaxSCCNN()
    variables = random_variables(jax_model.module, 31, seed=4)
    state = flax_sccnn_to_torch(variables)
    state_np = {k: v.numpy() for k, v in state.items()}
    _assert_trees_equal(jax_converter.torch_sccnn_to_flax({**state_np, "xv": 0, "yv": 0}), variables)
    pth = tmp_path / "sccnn.pth"
    torch.save({**state, "xv": torch.zeros(1, 1, 13, 13), "yv": torch.zeros(1, 1, 13, 13)}, pth)
    port, ioconfig = get_pretrained_model("sccnn-crchisto", pretrained_weights=pth, device="cpu")
    assert isinstance(port, SCCNN) and list(ioconfig.patch_output_shape) == [13, 13]
    batch = np.stack([SCCNN.preproc(p) for p in _patches(16, 31, seed=11)])
    np.testing.assert_array_equal(batch, np.stack([JaxSCCNN.preproc(p) for p in _patches(16, 31, seed=11)]))
    want = np.asarray(jax.jit(jax_model.module.apply)(variables, jnp.asarray(batch)))
    got = SCCNN.infer_batch(port, batch)
    assert got.shape == (16, 13, 13, 1)
    _close(got, want)
    # the bump is zero outside its radius, and both agree where it is
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize(("port_cls", "jax_cls"), [(MapDe, JaxMapDe), (SCCNN, JaxSCCNN)])
def test_postproc_peak_maps_match_jax(port_cls, jax_cls) -> None:
    """MapDe's and SCCNN's ``postproc`` (1.0 at each channel's peaks) equal JAX's."""
    from scipy import ndimage

    rng = np.random.default_rng(21)
    block = ndimage.gaussian_filter(rng.random((120, 90, 2)), (2, 2, 0)).astype(np.float32)
    block[30:34, 30:34, 0] = block.max()  # a plateau
    port, jax_model = port_cls.__new__(port_cls), jax_cls.__new__(jax_cls)
    for model in (port, jax_model):
        model.min_distance, model.threshold_abs = 4, float(np.quantile(block, 0.5))
    np.testing.assert_array_equal(port.postproc(block), jax_model.postproc(block))
    np.testing.assert_array_equal(
        port.postproc(block, min_distance=2, threshold_abs=0.0), jax_model.postproc(block, min_distance=2, threshold_abs=0.0)
    )


# -- MicroNet on the multitask engine, with the head in closed form ---------------------


def _closed_form_head(batch: np.ndarray) -> np.ndarray:
    """A two-class map of each standardised patch: foreground where it is dark."""
    from scipy import ndimage

    dark = -ndimage.uniform_filter(np.asarray(batch, np.float32).mean(-1), (1, 5, 5))
    p1 = 1.0 / (1.0 + np.exp(-4.0 * (dark - 0.8)))
    return np.stack([1.0 - p1, p1], axis=-1).astype(np.float32)


class _PortClosedForm(MicroNet):
    """The port's MicroNet with its head in closed form (no 184M-parameter build)."""

    def __init__(self) -> None:
        ModelABC.__init__(self)
        self.tasks = ["nuclei_segmentation"]
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    @classmethod
    def infer_batch_device(cls, model, batch_data, device=None):
        x = batch_data.numpy() if isinstance(batch_data, torch.Tensor) else np.asarray(batch_data)
        return torch.from_numpy(_closed_form_head(x))


class _JaxClosedForm(JaxMicroNet):
    @staticmethod
    def infer_batch_device(model, batch_data, device=None):
        return jnp.asarray(_closed_form_head(np.asarray(batch_data)))

    @staticmethod
    def infer_batch(model, batch_data, device=None):
        return (_closed_form_head(np.asarray(batch_data)),)


def test_micronet_on_the_multitask_engine_matches_jax(tmp_path) -> None:
    """One head, wrapped into a tuple by the engine; its own preproc, so the
    per-patch feed; the instances equal JAX's."""
    from test_torch_multitask import _assert_instances_match
    from tiatoolbox_tpu.models.engine.io_config import IOSegmentorConfig as JaxIOConfig
    from tiatoolbox_tpu.models.engine.multi_task_segmentor import MultiTaskSegmentor as JaxSegmentor
    from tiatoolbox_tpu_torch import PRETRAINED_MODELS
    from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide
    from tiatoolbox_tpu_torch.models.engine import IOSegmentorConfig, MultiTaskSegmentor

    slide = str(make_synthetic_slide(tmp_path / "consep.tiff", size=(560, 400), mpp=0.25, objective_power=40,
                                     seed=4, compression="deflate"))
    io = PRETRAINED_MODELS["micronet-consep"]["ioconfig"]["kwargs"]
    jax_model = _JaxClosedForm()
    jax_model.variables = {}  # the head is in closed form: no flax initialisation
    port = _PortClosedForm()
    port.place("cpu")
    common = dict(patch_mode=False, auto_get_mask=False)
    want = JaxSegmentor(jax_model, batch_size=4, num_loader_workers=0, verbose=False).run(
        [slide], ioconfig=JaxIOConfig(**io), **common
    )[slide]
    port_seg = MultiTaskSegmentor(port, batch_size=4, num_loader_workers=0, verbose=False, device="cpu")
    got = port_seg.run([slide], ioconfig=IOSegmentorConfig(**io), **common)[slide]
    assert port_seg.last_stage_summary["path"] == "multitask-device-canvas"
    assert _assert_instances_match(got["instances"], want["instances"]) > 10
