"""Tile-mode post-processing at ``chip_smoke.py``'s geometry: the port against JAX.

``chip_smoke.py``'s instance phase stitches ``hovernet_fast-pannuke``'s
heads over a 4096x3072 slide at 0.25 mpp (``make_synthetic_slide`` with
seed 41) and post-processes them twice: once as a whole canvas, and once
in tile mode (2048^2 tiles, a 128-pixel margin, the 4-pass merge). Its
functional checkpoint (``hovernet_checkpoint.py``) is a darkness detector,
so its stitched maps have a closed form, computed here from the slide's
base image without a forward:

- density ``d = relu(0.70 - mean7x7(rgb / 255))`` (the stem, zero outside
  the slide as the reader pads);
- ``np = sigmoid(80 (d - 0.03))``;
- ``hv = relu(-sobel3(d))`` in x and y, with zero padding at each 164^2
  output cell's edge (the decoder's ``u1`` convolution pads each patch);
- ``tp = 1`` where ``d > 0.03``, else 0.

``test_closed_form_is_the_functional_checkpoint`` holds the form against
the port's network on three output cells (a corner, the interior, the
bottom-right cell that overruns the slide). On these maps JAX and the port
keep the same instances, box for box and contour for contour, in tile
mode and on the whole canvas. The counts are 2004 in tile mode and 2386
on the whole canvas; the H100 run of ``chip_smoke.py`` counts 2004 and
2388, so tile mode's smaller count there is the reference's scheme on this
checkpoint's maps, not the port's merge.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy import ndimage

from test_torch_hovernet import _ShapeOnlyModel
from test_torch_multitask import _assert_instances_match
from tiatoolbox_tpu.models.architecture.hovernet import HoVerNet as JaxHoVerNet
from tiatoolbox_tpu.models.engine.multi_task_segmentor import MultiTaskSegmentor as JaxSegmentor
from tiatoolbox_tpu_torch.data.synth import synthetic_he_patch
from tiatoolbox_tpu_torch.models.architecture.hovernet import HoVerNet
from tiatoolbox_tpu_torch.models.architecture.hovernet_checkpoint import functional_hovernet_state_dict
from tiatoolbox_tpu_torch.models.engine import MultiTaskSegmentor
from tiatoolbox_tpu_torch.ops.canvas import pack_fg_tp
from tiatoolbox_tpu_torch.ops.hv_energy import hv_energy

SLIDE_WH = (4096, 3072)  # chip_smoke.INST_SLIDE_WH
SLIDE_SEED = 41
CELL = 164  # patch output and stride
CONTEXT = 46  # (256 - 164) / 2


@pytest.fixture(scope="module")
def image() -> np.ndarray:
    return synthetic_he_patch(SLIDE_WH, seed=SLIDE_SEED)


def _closed_form_maps(image: np.ndarray) -> list[np.ndarray]:
    """``[np, hv, tp]`` of the functional checkpoint, stitched, ``[H, W, C]`` float32."""
    h, w = image.shape[:2]
    rows, cols = -(-h // CELL), -(-w // CELL)
    grey = np.zeros((rows * CELL + 2 * CONTEXT, cols * CELL + 2 * CONTEXT), np.float32)
    grey[CONTEXT : CONTEXT + h, CONTEXT : CONTEXT + w] = image.astype(np.float32).mean(-1) / 255.0
    d = np.maximum(0.70 - ndimage.uniform_filter(grey, 7, mode="constant"), 0)
    d = d[CONTEXT:-CONTEXT, CONTEXT:-CONTEXT]
    sobel_x = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
    hv = np.zeros((*d.shape, 2), np.float32)
    for i in range(rows):
        for j in range(cols):
            cell = (slice(i * CELL, (i + 1) * CELL), slice(j * CELL, (j + 1) * CELL))
            for c, k in enumerate((sobel_x, sobel_x.T)):
                hv[(*cell, c)] = np.maximum(-ndimage.correlate(d[cell], k, mode="constant"), 0)
    np_map = 1.0 / (1.0 + np.exp(-80.0 * (d - 0.03)))
    tp = (d > 0.03).astype(np.float32)
    return [np_map[:h, :w, None].astype(np.float32), hv[:h, :w], tp[:h, :w, None]]


@pytest.fixture(scope="module")
def maps(image) -> list[np.ndarray]:
    return _closed_form_maps(image)


@pytest.fixture(scope="module")
def port_model() -> HoVerNet:
    model = HoVerNet(num_types=6, mode="fast", device="cpu")
    model.load_state_dict(functional_hovernet_state_dict(num_types=6, mode="fast"))
    return model


def test_closed_form_is_the_functional_checkpoint(image, maps, port_model) -> None:
    """np within 1e-2, hv within 1e-3 (of a 0.44 maximum), the type-1 area within a pixel."""
    h, w = image.shape[:2]
    padded = np.zeros((h + 2 * CELL, w + 2 * CELL, 3), np.uint8)
    padded[CONTEXT : CONTEXT + h, CONTEXT : CONTEXT + w] = image
    rows, cols = -(-h // CELL), -(-w // CELL)
    for i, j in ((0, 0), (3, 7), (rows - 1, cols - 1)):
        y, x = i * CELL, j * CELL
        np_map, hv, tp = HoVerNet.infer_batch(port_model, padded[y : y + 256, x : x + 256][None])
        ch, cw = min(CELL, h - y), min(CELL, w - x)
        want = [m[y : y + ch, x : x + cw] for m in maps]
        assert np.abs(np_map[0, :ch, :cw] - want[0]).max() <= 1e-2
        assert np.abs(hv[0, :ch, :cw] - want[1]).max() <= 1e-3
        assert abs(int((tp[0, :ch, :cw] == 1).sum()) - int(want[2].sum())) <= 1


def _jax_model() -> JaxHoVerNet:
    """Post-processing reads no weight; zero variables from their shapes spare
    the engine a ``model.init()``, most of a minute on a CPU."""
    model = JaxHoVerNet(num_types=6, mode="fast")
    shapes = _ShapeOnlyModel(6, "fast")
    shapes.init()
    model.load_weights(shapes.variables)
    return model


def _segmentors(port_model):
    jax_seg = JaxSegmentor(_jax_model(), verbose=False)
    port_seg = MultiTaskSegmentor(port_model, device="cpu", verbose=False)
    for seg in (jax_seg, port_seg):
        seg.tile_shape, seg.margin = (2048, 2048), 128  # the engines' defaults
    return jax_seg, port_seg


def _as_instances(result: dict) -> dict:
    info = result["info_dict"]
    return {
        i: {"box": info["box"][i], "centroid": info["centroid"][i], "contours": info["contours"][i],
            "type": info["type"][i]}
        for i in range(len(info["box"]))
    }


def test_tile_mode_matches_jax_at_the_smoke_geometry(maps, port_model) -> None:
    jax_seg, port_seg = _segmentors(port_model)
    want = jax_seg._process_tile_mode(maps, SLIDE_WH)
    want = want[0] if isinstance(want, tuple) else want
    got, _ = port_seg._process_tile_mode(maps, SLIDE_WH)
    assert _assert_instances_match(got, want) == 2004


def test_whole_canvas_matches_jax_at_the_smoke_geometry(maps, port_model) -> None:
    """JAX's host front-end on the raw maps against the port's banded planes
    (K6 and K5 through their plain versions), as the smoke's region feed
    fetches them."""
    (want,) = _jax_model().postproc(maps)
    canvas = torch.from_numpy(np.concatenate(maps, axis=-1))
    count = torch.ones((*canvas.shape[:2], 1))
    h, w = canvas.shape[:2]
    packed = pack_fg_tp(canvas, count, h, w, tp_channel=3)[0].numpy()
    energy = hv_energy(canvas[..., 1:3])[..., None].numpy()
    (got,) = port_model.postproc([packed, energy])
    assert _assert_instances_match(_as_instances(got), _as_instances(want)) == 2386
