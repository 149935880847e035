"""Engine outputs of the port against JAX's, on the CPU.

``PatchPredictor`` (resnet18, seeded flax variables carried over) and
``SemanticSegmentor`` (the narrow U-Net of ``test_torch_segmentor.py``) run a
small slide in both packages for every output type. The files must carry
JAX's names (``<slide stem><suffix>``), and their content must equal:

- exactly, against JAX's writer (the JAX engine's ``save_predictions``) fed
  the port's own processed predictions, so the writers are held bit for bit
  (zarr files byte for byte, stores row for row, QuPath features);
- within the models' tolerance, against the JAX engine's own run: the same
  geometry and classes, probabilities within 1e-4 (float32 convolutions
  summed in another order).

The slides are at 0.25 mpp and read at 0.5, so every store coordinate goes
through ``_calculate_scale_factor`` (2, 2). The semantic segmentor's host
canvas (``DEVICE_CANVAS_MAX_PIXELS = 0``) spilled to zarr
(``memory_threshold=0``) must equal the host canvas in RAM bit for bit, and
its cache must be gone afterwards. ``MultiTaskSegmentor.save_predictions``
writes one fixed instance dict in every type, against JAX's.
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from test_torch_segmentor import KWARGS as UNET_KWARGS
from test_torch_segmentor import _ioconfigs
from test_torch_unet import calibrated_state, flax_variables
from tiatoolbox_tpu.models.architecture.unet import UNetModel as JaxUNetModel
from tiatoolbox_tpu.models.architecture.vanilla import CNNModel as JaxCNNModel
from tiatoolbox_tpu.models.engine.io_config import IOPatchPredictorConfig as JaxIOConfig
from tiatoolbox_tpu.models.engine.multi_task_segmentor import MultiTaskSegmentor as JaxMultiTask
from tiatoolbox_tpu.models.engine.patch_predictor import PatchPredictor as JaxPatchPredictor
from tiatoolbox_tpu.models.engine.semantic_segmentor import SemanticSegmentor as JaxSegmentor
from tiatoolbox_tpu_torch import PRETRAINED_MODELS
from tiatoolbox_tpu_torch.annotation.storage import SQLiteStore
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide
from tiatoolbox_tpu_torch.models.architecture.unet import UNetModel
from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNModel
from tiatoolbox_tpu_torch.models.architecture.weight_converter import (
    flax_resnet_to_torch,
    flax_unet_to_torch,
)
from tiatoolbox_tpu_torch.models.engine import MultiTaskSegmentor, SemanticSegmentor
from tiatoolbox_tpu_torch.models.engine.io_config import IOPatchPredictorConfig
from tiatoolbox_tpu_torch.models.engine.patch_predictor import PatchPredictor
from tiatoolbox_tpu_torch.utils.zarrlite import open_zarr

SUFFIX = {"zarr": ".zarr", "annotationstore": ".db", "qupath": ".json", "ome-tiff": ".ome.tiff"}
CLASSES = {i: f"tissue{i}" for i in range(9)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def slide(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("outputs") / "slide_a.tiff"
    make_synthetic_slide(path, size=(1344, 896), mpp=0.25, objective_power=40, seed=5, compression="deflate")
    return str(path)


def _same_tree(a: Path, b: Path) -> None:
    names_a = sorted(p.relative_to(a).as_posix() for p in a.rglob("*"))
    assert names_a == sorted(p.relative_to(b).as_posix() for p in b.rglob("*"))
    for name in names_a:
        if (a / name).is_file():
            assert (a / name).read_bytes() == (b / name).read_bytes(), name


def _rows(path) -> list:
    store = SQLiteStore(path)
    rows = sorted(
        (a.geometry.to_wkb(), json.dumps(a.properties, sort_keys=True)) for a in store.values()
    )
    store.close()
    return rows


def _features(path) -> list:
    return sorted(json.dumps(f, sort_keys=True) for f in json.loads(Path(path).read_text())["features"])


def _close_rows(got: list, want: list) -> None:
    """Rows with the same geometry and properties, ``prob`` within 1e-4."""
    assert len(got) == len(want) > 0
    for (g_wkb, g_props), (w_wkb, w_props) in zip(got, want):
        assert g_wkb == w_wkb
        g, w = json.loads(g_props), json.loads(w_props)
        assert g.pop("prob", 0) == pytest.approx(w.pop("prob", 0), abs=1e-4)
        assert g == w


def _assert_same_writer_output(kind: str, got: Path, want: Path) -> None:
    assert got.name == want.name
    if kind in ("zarr", "ome-tiff"):
        if got.is_dir():
            _same_tree(got, want)
        else:
            assert got.read_bytes() == want.read_bytes()
    elif kind == "annotationstore":
        assert _rows(got) == _rows(want)
    else:
        assert _features(got) == _features(want)


@pytest.fixture(scope="module")
def predictors():
    jax_model = JaxCNNModel("resnet18", num_classes=9)
    jax_model.init(input_shape=(1, 224, 224, 3))
    rng = np.random.default_rng(7)
    variables = jax.tree_util.tree_map(
        lambda leaf: (np.asarray(leaf) + rng.normal(0, 0.05, leaf.shape)).astype(np.float32),
        jax_model.variables,
    )
    jax_model.load_weights(variables)
    port_model = CNNModel("resnet18", num_classes=9, device="cpu")
    port_model.load_state_dict(flax_resnet_to_torch(variables))
    jax_engine = JaxPatchPredictor(model=jax_model, batch_size=4, verbose=False)
    port_engine = PatchPredictor(model=port_model, batch_size=4, verbose=False, device="cpu")
    return jax_engine, port_engine


IOCONFIG = PRETRAINED_MODELS["resnet18-kather100k"]["ioconfig"]["kwargs"]


@pytest.mark.parametrize("kind", ["zarr", "annotationstore", "qupath"])
def test_patch_predictor_outputs_match_jax(predictors, slide: str, tmp_path, kind: str) -> None:
    jax_engine, port_engine = predictors
    common = dict(patch_mode=False, auto_get_mask=False, class_dict=CLASSES, output_type=kind)
    got = port_engine.run([slide], ioconfig=IOPatchPredictorConfig(**IOCONFIG), save_dir=tmp_path / "port", **common)
    want = jax_engine.run([slide], ioconfig=JaxIOConfig(**IOCONFIG), save_dir=tmp_path / "jax", **common)
    got_path, want_path = Path(got[slide]), Path(want[slide])
    assert got_path == tmp_path / "port" / f"slide_a{SUFFIX[kind]}"
    assert want_path.name == got_path.name

    # the writer, bit for bit: JAX's save_predictions on the port's predictions
    processed = port_engine.run([slide], ioconfig=IOPatchPredictorConfig(**IOCONFIG), **{**common, "output_type": "dict"})[slide]
    (tmp_path / "jax_writer").mkdir()
    again = jax_engine.save_predictions(
        processed, kind, tmp_path / "jax_writer", output_file=got_path.name, scale_factor=(2.0, 2.0)
    )
    _assert_same_writer_output(kind, got_path, Path(again))

    # the JAX engine's own run, within the model tolerance
    if kind == "zarr":
        g, w = open_zarr(got_path), open_zarr(want_path)
        assert g.keys() == w.keys() == ["coordinates", "predictions", "probabilities"]
        np.testing.assert_array_equal(np.asarray(g["coordinates"]), np.asarray(w["coordinates"]))
        np.testing.assert_array_equal(np.asarray(g["predictions"]), np.asarray(w["predictions"]))
        np.testing.assert_allclose(np.asarray(g["probabilities"]), np.asarray(w["probabilities"]), atol=1e-4)
    elif kind == "annotationstore":
        rows = _rows(got_path)
        _close_rows(rows, _rows(want_path))
        # baseline coordinates: 224-pixel patches read at 0.5 mpp span 448 at 0.25
        x0, y0, x1, y1 = SQLiteStore(got_path).bquery().popitem()[1]
        assert (x1 - x0, y1 - y0) == (448.0, 448.0)
    else:
        g, w = json.loads(got_path.read_text()), json.loads(want_path.read_text())
        assert len(g["features"]) == len(w["features"]) > 0
        for gf, wf in zip(g["features"], w["features"]):
            assert gf["geometry"] == wf["geometry"]
            assert gf["properties"]["classification"] == wf["properties"]["classification"]


@pytest.fixture(scope="module")
def unets(slide: str):
    state = calibrated_state(UNET_KWARGS, seed=22)
    # shift the classifier's biases by the log of each class's mean
    # probability on this slide, so the class map holds every class
    port = UNetModel(**UNET_KWARGS, device="cpu")
    port.load_state_dict(state)
    seg = SemanticSegmentor(port, batch_size=8, num_loader_workers=2, device="cpu", verbose=False)
    probs = seg.run([slide], patch_mode=False, ioconfig=_ioconfigs(0.5, 64, 48)[1], auto_get_mask=False)[slide]
    mean = probs["probabilities"].reshape(-1, probs["probabilities"].shape[-1]).mean(0)
    state["clf.bias"] = state["clf.bias"] - torch.from_numpy(np.log(mean).astype(np.float32))
    variables = flax_variables(state)
    jax_model = JaxUNetModel(**UNET_KWARGS)
    jax_model.load_weights(variables)
    port = UNetModel(**UNET_KWARGS, device="cpu")
    port.load_state_dict(flax_unet_to_torch(variables))
    return jax_model, port


@pytest.mark.parametrize("kind", ["zarr", "annotationstore", "qupath", "ome-tiff"])
def test_semantic_segmentor_outputs_match_jax(unets, slide: str, tmp_path, kind: str) -> None:
    jax_model, port = unets
    jax_io, port_io = _ioconfigs(0.5, 64, 48)
    jax_seg = JaxSegmentor(jax_model, batch_size=8, num_loader_workers=2, verbose=False)
    port_seg = SemanticSegmentor(port, batch_size=8, num_loader_workers=2, device="cpu", verbose=False)
    common = dict(patch_mode=False, auto_get_mask=False, output_type=kind)
    got = Path(port_seg.run([slide], ioconfig=port_io, save_dir=tmp_path / "port", **common)[slide])
    assert got == tmp_path / "port" / f"slide_a{SUFFIX[kind]}"
    processed = port_seg.post_process_wsi(
        port_seg.infer_wsi(port_seg.get_dataloader(slide, ioconfig=port_io, patch_mode=False))
    )
    (tmp_path / "jax_writer").mkdir()
    if kind == "qupath":
        # JAX's engine returns the dict for "qupath"; its converters write the file
        from tiatoolbox_tpu.utils.store_conversion import (
            dict_to_store_semantic_segmentor,
            store_to_qupath_json,
        )

        again = store_to_qupath_json(
            dict_to_store_semantic_segmentor(processed, scale_factor=(2.0, 2.0)),
            tmp_path / "jax_writer" / got.name,
        )
    else:
        again = jax_seg.save_predictions(
            processed, kind, tmp_path / "jax_writer", output_file=got.name, scale_factor=(2.0, 2.0)
        )
        want = Path(jax_seg.run([slide], ioconfig=jax_io, save_dir=tmp_path / "jax", **common)[slide])
        assert want.name == got.name
    _assert_same_writer_output(kind, got, Path(again))
    if kind == "zarr":
        g, w = open_zarr(got), open_zarr(want)
        assert g.keys() == w.keys() == ["predictions", "probabilities"]
        np.testing.assert_allclose(np.asarray(g["probabilities"]), np.asarray(w["probabilities"]), atol=1e-4)
    elif kind == "annotationstore":
        got_rows, want_rows = _rows(got), _rows(want)
        assert len(got_rows) > 0
        # contours follow the class map, which equals JAX's where the top-2
        # probability margin exceeds 1e-3 (test_torch_segmentor.py)
        assert abs(len(got_rows) - len(want_rows)) <= max(2, len(want_rows) // 10)


def test_semantic_spill_equals_ram_bit_for_bit(unets, slide: str, tmp_path) -> None:
    _, port = unets
    _, port_io = _ioconfigs(0.5, 64, 48)
    seg = SemanticSegmentor(port, batch_size=8, num_loader_workers=2, device="cpu", verbose=False)
    seg.DEVICE_CANVAS_MAX_PIXELS = 0
    common = dict(patch_mode=False, ioconfig=port_io, auto_get_mask=False)
    ram = seg.run([slide], memory_threshold=1.0, save_dir=tmp_path / "ram", output_type="zarr", **common)
    assert seg.last_stage_summary["path"] == "host-canvas" and seg.spill_bytes == 0
    spilled = seg.run([slide], memory_threshold=0.0, save_dir=tmp_path / "zarr", output_type="zarr", **common)
    assert seg.spill_bytes > 0
    assert not (tmp_path / "zarr" / "cache").exists() and not (tmp_path / "ram" / "cache").exists()
    _same_tree(Path(ram[slide]), Path(spilled[slide]))
    in_dict = seg.run([slide], memory_threshold=0.0, save_dir=tmp_path / "dict", **common)[slide]
    assert isinstance(in_dict["probabilities"], np.ndarray)
    np.testing.assert_array_equal(in_dict["probabilities"], np.asarray(open_zarr(ram[slide])["probabilities"]))


def _instances(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(40):
        c = rng.uniform(20, 900, 2)
        t = np.linspace(0, 2 * np.pi, 7, endpoint=False)
        contour = np.round(c + rng.uniform(3, 9) * np.stack([np.cos(t), np.sin(t)], -1)).astype(np.int32)
        out[f"{i:08x}-0000-4000-8000-000000000000"] = {
            "box": np.concatenate([contour.min(0), contour.max(0)]),
            "centroid": c,
            "contours": contour,
            "prob": float(rng.random()),
            "type": int(rng.integers(0, 6)),
            "task_type": None,
        }
    return out


@pytest.mark.parametrize("kind", ["dict", "zarr", "annotationstore", "qupath"])
def test_multitask_save_predictions_match_jax(tmp_path, kind: str) -> None:
    types = {0: "nolabe", 1: "neopla", 2: "inflam", 3: "connec", 4: "necros", 5: "no-neo"}
    engines = []
    for cls in (MultiTaskSegmentor, JaxMultiTask):
        engine = cls.__new__(cls)  # save_predictions reads the model's type names only
        engine.model = SimpleNamespace(nuc_type_dict=types)
        engine.class_dict = None
        engines.append(engine)
    processed = {"instances": _instances(3), "canvas_wh": (1000, 1000)}
    name = f"s{SUFFIX.get(kind, '')}"
    outputs = []
    for engine, folder in zip(engines, ("p", "j")):
        (tmp_path / folder).mkdir()
        outputs.append(
            engine.save_predictions(processed, kind, tmp_path / folder, output_file=name, scale_factor=(2.0, 2.0))
        )
    got, want = outputs
    if kind == "dict":
        assert got is processed and want is processed
        return
    _assert_same_writer_output(kind, Path(got), Path(want))
    if kind == "annotationstore":
        store = SQLiteStore(got)
        assert len(store) == 40 and sorted(store.keys()) == sorted(processed["instances"])
        assert {a.properties["type"] for a in store.values()} <= set(types.values())
    if kind == "zarr":
        assert open_zarr(got).attrs == open_zarr(want).attrs
        assert len(open_zarr(got).attrs["instances"]) == 40
    with pytest.raises(ValueError, match="Patch-mode"):
        engines[0].save_predictions({"instances": [{}]}, kind, tmp_path / "p")
