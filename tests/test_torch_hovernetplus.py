"""HoVer-Net+: the port's network, layer post-processing and engine path against JAX and cv2 on the CPU.

- The forward of ``hovernetplus-oed``'s network (3 nucleus types, 5
  layers, full width) on one 256^2 patch, with seeded random flax variables
  (built from ``jax.eval_shape``) carried in by ``flax_hovernet_to_torch``:
  np and hv within 1e-4 of their largest magnitude, the tp and ls argmax
  equal wherever the top two probabilities are more than 1e-3 apart.
- ``_proc_ls`` and ``_get_layer_info`` equal JAX's bit for bit on seeded
  layer maps whose epithelium passes the 20,000-pixel filter; the 20x20
  closing and opening equal ``cv2.morphologyEx``, and the tree contours
  ``cv2.findContours(RETR_TREE, CHAIN_APPROX_NONE)``, on random, nested and
  edge-touching masks.
- The multitask engine on a small slide with both models' heads replaced
  by the same closed-form maps of each patch (np, hv, tp and ls from its
  greyscale), on the whole canvas and in tile mode, where the layer map
  goes through the semantic canvases: the port's instances (nuclei and
  layer contours) and layer map equal JAX's. HoVer-Net+'s four heads take
  the generic fetch in both packages.
"""

from __future__ import annotations

from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from test_torch_micronet import random_variables
from test_torch_multitask import _assert_instances_match
from tiatoolbox_tpu.models.architecture.hovernetplus import HoVerNetPlus as JaxHoVerNetPlus
from tiatoolbox_tpu.models.architecture.weight_converter import torch_hovernet_to_flax
from tiatoolbox_tpu.models.engine.io_config import IOInstanceSegmentorConfig as JaxIOConfig
from tiatoolbox_tpu.models.engine.multi_task_segmentor import MultiTaskSegmentor as JaxSegmentor
from tiatoolbox_tpu.utils.misc import get_bounding_box as jax_bounding_box
from tiatoolbox_tpu_torch import PRETRAINED_MODELS, native
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide, synthetic_he_patch
from tiatoolbox_tpu_torch.models.architecture import get_pretrained_model
from tiatoolbox_tpu_torch.models.architecture.hovernetplus import (
    HoVerNetPlus,
    morphology_close,
    morphology_open,
)
from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_hovernet_to_torch
from tiatoolbox_tpu_torch.models.engine import IOInstanceSegmentorConfig, MultiTaskSegmentor
from tiatoolbox_tpu_torch.utils.misc import get_bounding_box

KWARGS = PRETRAINED_MODELS["hovernetplus-oed"]["architecture"]["kwargs"]


@pytest.fixture(autouse=True, scope="module")
def _four_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def test_registry_entry_and_forward_match_flax() -> None:
    import yaml

    reference = yaml.safe_load(
        (Path(__file__).resolve().parents[1] / "tiatoolbox_tpu/data/pretrained_model.yaml").read_text()
    )
    for name in ("hovernetplus-oed", "micronet-consep", "mapde-conic", "mapde-crchisto", "sccnn-conic", "sccnn-crchisto"):
        assert PRETRAINED_MODELS[name]["architecture"] == reference[name]["architecture"], name
        assert PRETRAINED_MODELS[name]["ioconfig"] == reference[name]["ioconfig"], name
    jax_model = JaxHoVerNetPlus(**KWARGS)
    variables = random_variables(jax_model.module, 256, seed=17)
    state = flax_hovernet_to_torch(variables)
    assert any(k.startswith("decoder.ls.u3.conva") for k in state)
    back = torch_hovernet_to_flax({k: v.numpy() for k, v in state.items()})
    for collection in ("params", "batch_stats"):
        flat_back = jax.tree_util.tree_leaves_with_path(back[collection])
        flat_want = dict(jax.tree_util.tree_leaves_with_path(variables[collection]))
        assert len(flat_back) == len(flat_want)
        for path, value in flat_back:
            assert np.array_equal(value, flat_want[path]), path
    port, ioconfig = get_pretrained_model("hovernetplus-oed", device="cpu")
    port.load_state_dict(state)
    assert list(port.decoder) == ["tp", "np", "hv", "ls"] and ioconfig.margin == 128
    patch = synthetic_he_patch((256, 256), seed=5)[None]
    logits = jax.jit(jax_model.module.apply)(variables, jnp.asarray(patch, jnp.float32))
    jax_model.variables = variables
    want = [np.asarray(h) for h in JaxHoVerNetPlus.infer_batch_device(jax_model, patch)]
    got = [h.numpy() for h in HoVerNetPlus.infer_batch_device(port, patch)]
    assert [g.shape for g in got] == [(1, 164, 164, c) for c in (1, 2, 1, 1)]
    for g, w in zip(got[:2], want[:2]):
        assert float(np.abs(g - w).max()) <= 1e-4 * float(np.abs(w).max())
    for i, head in ((2, "tp"), (3, "ls")):
        probs = np.sort(np.asarray(jax.nn.softmax(logits[head], axis=-1)), axis=-1)
        clear = (probs[..., -1] - probs[..., -2]) > 1e-3
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(got[i][..., 0][clear], want[i][..., 0][clear])
    # four heads: the generic fetch, in both packages
    assert not port.banded_fetch_spec([1, 2, 1, 1])
    assert jax_model.banded_fetch_spec([1, 2, 1, 1]) is None


def _masks() -> dict:
    rng = np.random.default_rng(3)
    field = ndimage.gaussian_filter(rng.random((160, 190)), 6)
    blobs = (field > np.quantile(field, 0.6)).astype(np.uint8)
    nested = np.zeros((90, 90), np.uint8)
    for i, v in enumerate((1, 0, 1, 0, 1, 0, 1)):
        nested[4 + 5 * i : 86 - 5 * i, 4 + 5 * i : 86 - 5 * i] = v
    edge = np.zeros((70, 50), np.uint8)
    edge[:15, :] = 1  # touches three sides
    edge[40:, 30:] = 1  # a corner
    edge[25:32, 0:3] = 1  # thinner than the kernel, at the left edge
    return {
        "random": (rng.random((80, 100)) < 0.5).astype(np.uint8),
        "sparse": (rng.random((64, 64)) < 0.02).astype(np.uint8),
        "blobs": blobs,
        "holes": (blobs & (rng.random(blobs.shape) > 0.05)).astype(np.uint8),
        "nested": nested,
        "edge": edge,
        "full": np.ones((25, 30), np.uint8),
        "empty": np.zeros((25, 30), np.uint8),
    }


@pytest.mark.parametrize("name", list(_masks()))
def test_morphology_and_tree_contours_match_cv2(name: str) -> None:
    mask = _masks()[name]
    kernel = np.ones((20, 20), np.uint8)
    np.testing.assert_array_equal(morphology_close(mask), cv2.morphologyEx(mask, cv2.MORPH_CLOSE, kernel))
    np.testing.assert_array_equal(morphology_open(mask), cv2.morphologyEx(mask, cv2.MORPH_OPEN, kernel))
    np.testing.assert_array_equal(morphology_close(mask, 5), cv2.morphologyEx(mask, cv2.MORPH_CLOSE, np.ones((5, 5))))
    want, want_h = cv2.findContours(mask, cv2.RETR_TREE, cv2.CHAIN_APPROX_NONE)
    got, got_h = native.find_contours_tree(mask)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w[:, 0, :])
    if len(want):
        np.testing.assert_array_equal(got_h, want_h[0])


def test_tree_contours_match_cv2_on_many_masks() -> None:
    """RETR_TREE differs from RETR_CCOMP on islands in holes; hundreds of
    seeded masks, many with more than 127 borders (OpenCV's label wrap)."""
    rng = np.random.default_rng(8)
    for trial in range(300):
        h, w = rng.integers(1, 70, 2)
        mask = (rng.random((h, w)) < rng.random()).astype(np.uint8)
        if trial % 2:
            mask = (ndimage.gaussian_filter(rng.random((h, w)), 1.5) > 0.5).astype(np.uint8)
        want, want_h = cv2.findContours(mask, cv2.RETR_TREE, cv2.CHAIN_APPROX_NONE)
        got, got_h = native.find_contours_tree(mask)
        assert len(got) == len(want)
        assert all(np.array_equal(g, w[:, 0, :]) for g, w in zip(got, want))
        if len(want):
            assert np.array_equal(got_h, want_h[0])


def _layer_map(shape, seed: int) -> np.ndarray:
    """A seeded layer map: smooth bands of layers 0-4 with speckle, large
    enough regions of epithelium (2-4) to pass the 20,000-pixel filter."""
    rng = np.random.default_rng(seed)
    field = ndimage.gaussian_filter(rng.random(shape), 18)
    field = (field - field.min()) / (field.max() - field.min())
    layers = np.digitize(field, [0.2, 0.35, 0.55, 0.8]).astype(np.float32)
    speckle = rng.random(shape) < 0.02
    layers[speckle] = rng.integers(0, 5, int(speckle.sum()))
    return layers[..., None]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_proc_ls_and_layer_info_match_jax(seed: int) -> None:
    ls_map = _layer_map((420, 380), seed)
    got = HoVerNetPlus._proc_ls(ls_map)
    want = JaxHoVerNetPlus._proc_ls(ls_map)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) >= {1, 2}  # epithelium survives the filter
    assert ((ls_map[..., 0] >= 2) & (got < 2)).any()  # and some is removed or opened away
    offset = (5, 9) if seed else (0, 0)
    got_info = HoVerNetPlus._get_layer_info(got, offset)
    want_info = JaxHoVerNetPlus._get_layer_info(want, offset)
    assert list(got_info) == list(want_info) and len(got_info) > 3
    for k, w in want_info.items():
        g = got_info[k]
        assert g["type"] == w["type"] and g["prob"] is w["prob"] is None
        for key in ("box", "contours", "centroid"):
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype
            np.testing.assert_array_equal(g[key], w[key])
    for mask in (got == 2, got > 0, ls_map[..., 0] == 4):
        box = get_bounding_box(mask)
        assert box.dtype == jax_bounding_box(mask).dtype
        np.testing.assert_array_equal(box, jax_bounding_box(mask))


# -- the engine, with both models' heads in closed form --------------------------------

CROP = (256 - 164) // 2


def _closed_form_heads(batch: np.ndarray) -> list[np.ndarray]:
    """[np, hv, tp, ls] of each 256^2 patch's central 164^2, from its greyscale:
    np, hv and tp as the functional HoVer-Net checkpoint's darkness detector
    gives them (``tests/test_torch_tile_mode.py``), the layers from the 9x9
    mean in bands wide enough to pass the 20,000-pixel epithelium filter on
    the stitched map."""
    full = np.asarray(batch, np.float32).mean(-1) / 255.0
    crop = (slice(None), slice(CROP, -CROP), slice(CROP, -CROP))
    d = np.maximum(0.70 - ndimage.uniform_filter(full, (1, 7, 7), mode="constant"), 0)[crop]
    sobel_x = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
    hv = np.stack(
        [np.maximum(-ndimage.correlate(d, k[None], mode="constant"), 0) for k in (sobel_x, sobel_x.T)], axis=-1
    )
    np_map = 1.0 / (1.0 + np.exp(-80.0 * (d - 0.03)))
    tp = np.where(d > 0.03, 1 + (d > 0.1), 0)
    smooth = ndimage.uniform_filter(full, (1, 9, 9))[crop]
    ls = 4 - np.digitize(smooth, [0.8, 0.86, 0.9, 0.95])
    return [h[..., None] if h.ndim == 3 else h for h in (np_map, hv, tp, ls)]


def _as_float32(heads: list[np.ndarray]) -> list[np.ndarray]:
    return [np.ascontiguousarray(h, np.float32) for h in heads]


class _PortClosedForm(HoVerNetPlus):
    @classmethod
    def infer_batch_device(cls, model, batch_data, device=None):
        x = batch_data.numpy() if isinstance(batch_data, torch.Tensor) else np.asarray(batch_data)
        return tuple(torch.from_numpy(h) for h in _as_float32(_closed_form_heads(x)))


class _JaxClosedForm(JaxHoVerNetPlus):
    @staticmethod
    def infer_batch_device(model, batch_data, device=None):
        return tuple(jnp.asarray(h) for h in _as_float32(_closed_form_heads(np.asarray(batch_data))))

    @staticmethod
    def infer_batch(model, batch_data, device=None):
        return tuple(_as_float32(_closed_form_heads(np.asarray(batch_data))))


IOCONFIG = dict(PRETRAINED_MODELS["hovernetplus-oed"]["ioconfig"]["kwargs"], margin=64)


@pytest.fixture(scope="module")
def slide(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("hvp") / "oed.tiff"
    make_synthetic_slide(path, size=(820, 600), mpp=0.5, seed=23, compression="deflate")
    return str(path)


def _run_both(slide: str, tiles: bool):
    port = _PortClosedForm(**KWARGS, device="cpu")
    jax_model = _JaxClosedForm(**KWARGS)
    jax_model.variables = {}  # the heads are in closed form: no flax initialisation
    port_seg = MultiTaskSegmentor(port, batch_size=4, num_loader_workers=0, verbose=False, device="cpu")
    jax_seg = JaxSegmentor(jax_model, batch_size=4, num_loader_workers=0, verbose=False)
    if tiles:
        for seg in (port_seg, jax_seg):
            seg.full_postproc_limit = 100_000
            seg.tile_shape = (256, 256)
    want = jax_seg.run([slide], patch_mode=False, ioconfig=JaxIOConfig(**IOCONFIG), auto_get_mask=False)[slide]
    got = port_seg.run(
        [slide], patch_mode=False, ioconfig=IOInstanceSegmentorConfig(**IOCONFIG), auto_get_mask=False
    )[slide]
    return got, want, port_seg, jax_seg


@pytest.mark.parametrize("tiles", [False, True])
def test_engine_layers_and_instances_match_jax(slide, tiles: bool) -> None:
    got, want, port_seg, jax_seg = _run_both(slide, tiles)
    path = port_seg.last_stage_summary["path"]
    assert "banded" not in path and "banded" not in jax_seg.last_stage_summary["path"]
    assert path == ("multitask-device-canvas+region-feed" if tiles else "multitask-device-canvas+region-feed+device-energy")
    layers_got = np.asarray(got["semantic_predictions"]["layer_segmentation"])
    layers_want = np.asarray(want["semantic_predictions"]["layer_segmentation"])
    assert layers_got.shape == (600, 820)
    np.testing.assert_array_equal(layers_got, layers_want)
    assert set(np.unique(layers_got)) >= {1, 2}
    tasks = [v["task_type"] for v in got["instances"].values()]
    assert tasks.count("layer_segmentation") > 0 and tasks.count("nuclei_segmentation") > 10
    _assert_instances_match(got["instances"], want["instances"])
