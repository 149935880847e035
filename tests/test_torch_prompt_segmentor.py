"""The port's PromptSegmentor against JAX's.

JAX's ``TestPromptSegmentor`` cases (``tests/engines/test_segmentors.py``:
a stub SAM, the stores saved per tile, offset and scale, the prompts
required) run through both packages' engines; then a tiny real SAM
(``test_torch_sam``'s checkpoint, written by transformers and loaded by
both packages) with points, a box, and both, over tiles of two sizes and
with ``calc_mpp``'s scale and an offset. The stores' geometries and
properties are equal. ``device=None`` resolves to the card (``resolve_device``
raises without one); ``"cpu"`` moves the model to the CPU.
"""

from __future__ import annotations

import json
import os

os.environ.setdefault("USE_TF", "0")  # transformers imports TensorFlow otherwise
os.environ.setdefault("HF_HUB_OFFLINE", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from test_torch_sam import hf_config, write_checkpoint  # noqa: E402

from tiatoolbox_tpu.annotation.storage import SQLiteStore as JaxSQLiteStore  # noqa: E402
from tiatoolbox_tpu.models.architecture.sam import SAM as JaxSAM  # noqa: E402
from tiatoolbox_tpu.models.engine.prompt_segmentor import PromptSegmentor as JaxPromptSegmentor  # noqa: E402
from tiatoolbox_tpu_torch import rcParam  # noqa: E402
from tiatoolbox_tpu_torch.annotation.storage import SQLiteStore  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.sam import SAM  # noqa: E402
from tiatoolbox_tpu_torch.models.engine import PromptSegmentor  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class StubSAM:
    """JAX's stub (``tests/engines/test_segmentors.py:322-335``)."""

    def infer_batch(self, images, point_coords=None, box_coords=None):
        masks = []
        for i, img in enumerate(np.asarray(images)):
            h, w = img.shape[:2]
            mask = np.zeros((1, 3, h, w), bool)
            if point_coords is not None:
                x, y = (int(v) for v in np.asarray(point_coords[i])[0])
                mask[0, 0, max(y - 5, 0) : y + 5, max(x - 5, 0) : x + 5] = True
            if box_coords is not None:
                x0, y0, x1, y1 = (int(v) for v in np.asarray(box_coords[i])[0])
                mask[0, 1, y0:y1, x0:x1] = True
            masks.append(mask)
        return masks


def rows(path, store_cls) -> list:
    return sorted((a.geometry.to_wkb(), json.dumps(a.properties, sort_keys=True)) for a in store_cls(path).values())


def both(tmp_path, name: str, jax_model, port_model, scale_area=None, offset=None, **run_kwargs):
    """The same run through JAX's and the port's engine; their stores' rows."""
    out = []
    for cls, model, store_cls, extra in (
        (JaxPromptSegmentor, jax_model, JaxSQLiteStore, {}),
        (PromptSegmentor, port_model, SQLiteStore, {"device": "cpu"}),
    ):
        seg = cls(model=model)
        if scale_area is not None:
            seg.calc_mpp(scale_area, base_mpp=0.5)
        if offset is not None:
            seg.offset = np.array(offset)
        paths = seg.run(save_dir=tmp_path / f"{name}_{cls.__module__.split('.')[0]}", **run_kwargs, **extra)
        out.append([rows(p, store_cls) for p in paths])
    return out


def test_run_saves_stores(tmp_path) -> None:
    images = [np.zeros((64, 64, 3), np.uint8)] * 2
    points = np.array([[[20, 20]], [[40, 40]]])
    want, got = both(tmp_path, "p", StubSAM(), StubSAM(), images=images, point_coords=points)
    assert got == want and len(got) == 2
    paths = PromptSegmentor(model=StubSAM()).run(images, point_coords=points, save_dir=tmp_path / "q", device="cpu")
    anns = list(SQLiteStore(paths[0]).values())
    assert len(anns) == 1
    x0, y0, x1, y1 = anns[0].geometry.bounds
    assert 14 <= x0 <= 16 and 14 <= y0 <= 16  # around the point prompt


def test_offset_and_scale(tmp_path) -> None:
    seg = PromptSegmentor(model=StubSAM())
    mpp, scale = seg.calc_mpp((3000, 1500), base_mpp=0.5)
    assert scale == 2.0 and mpp == 1.0
    seg.offset = np.array([100, 200])
    images = [np.zeros((64, 64, 3), np.uint8)]
    boxes = np.array([[[10, 10, 30, 30]]])
    paths = seg.run(images, box_coords=boxes, save_dir=tmp_path / "q", device="cpu")
    x0, y0, _, _ = next(iter(SQLiteStore(paths[0]).values())).geometry.bounds
    assert x0 == 120 and y0 == 220  # scaled by 2 then offset by (100, 200)
    want, got = both(
        tmp_path, "r", StubSAM(), StubSAM(), scale_area=(3000, 1500), offset=(100, 200), images=images, box_coords=boxes
    )
    assert got == want


def test_requires_prompts(tmp_path) -> None:
    seg = PromptSegmentor(model=StubSAM())
    with pytest.raises(ValueError, match="point_coords or box_coords"):
        seg.run([np.zeros((8, 8, 3), np.uint8)], save_dir=tmp_path, device="cpu")
    with pytest.raises(ValueError, match="point_coords or box_coords"):
        JaxPromptSegmentor(model=StubSAM()).run([np.zeros((8, 8, 3), np.uint8)], save_dir=tmp_path)


@pytest.mark.parametrize(
    ("area", "base_mpp", "fixed"),
    [((3000, 1500), 0.5, 1500), ((1024, 1024), 0.25, 1500), ((1501, 20), 0.5, 1500), ((800, 2400), 1.0, 1000)],
)
def test_calc_mpp(area, base_mpp, fixed) -> None:
    jax_seg, port_seg = JaxPromptSegmentor(model=StubSAM()), PromptSegmentor(model=StubSAM())
    assert port_seg.calc_mpp(area, base_mpp, fixed) == jax_seg.calc_mpp(area, base_mpp, fixed)
    assert port_seg.scale == jax_seg.scale


@pytest.fixture(scope="module")
def tiny_sams(tmp_path_factory):
    directory = write_checkpoint(tmp_path_factory.mktemp("sam"), hf_config("grid10_win4"), seed=21)
    return JaxSAM(str(directory)), SAM(directory, device="cpu")


@pytest.mark.parametrize("prompt", ["points", "box", "point_box"])
@pytest.mark.parametrize("tile", ["square", "wide"])
def test_tiny_sam_stores_match_jax(tiny_sams, tmp_path, tile, prompt) -> None:
    """Two tiles of one size a call (square at scale 1; wide with calc_mpp's
    scale 1.6 and an offset), each prompt kind as nested lists."""
    jsam, psam = tiny_sams
    shape, area, offset = {"square": ((160, 160), None, None), "wide": ((100, 150), (2400, 1600), (300, 40))}[tile]
    images = list(np.random.default_rng(len(tile) + len(prompt)).integers(0, 256, (2, *shape, 3), dtype=np.uint8))
    kwargs = {
        "points": {"point_coords": [[[40, 50], [90, 60]], [[20, 70], [100, 30]]]},
        "box": {"box_coords": [[[15, 10, 110, 90]], [[30, 20, 140, 95]]]},
        "point_box": {"point_coords": [[[60, 45]], [[70, 50]]], "box_coords": [[[20, 15, 120, 95]], [[40, 10, 130, 90]]]},
    }[prompt]
    want, got = both(tmp_path, "t", jsam, psam, scale_area=area, offset=offset, images=images, **kwargs)
    assert got == want
    assert sum(len(r) for r in got) > 0


def test_device_none_resolves_to_the_card(tiny_sams, tmp_path, monkeypatch) -> None:
    _, psam = tiny_sams
    seg = PromptSegmentor(model=psam)
    images = [np.zeros((40, 40, 3), np.uint8)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        seg.run(images, point_coords=[[[10, 10]]], save_dir=tmp_path / "a")
    monkeypatch.setitem(rcParam, "device", "cpu")
    assert len(seg.run(images, point_coords=[[[10, 10]]], save_dir=tmp_path / "b")) == 1
    assert psam.device == torch.device("cpu")
