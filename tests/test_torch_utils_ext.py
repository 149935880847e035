"""The rest of ``utils/``, ``data/`` and the engines' helpers against JAX's.

Every function of this slice's utilities runs in both packages on the
same seeded inputs: the file helpers of ``utils/misc.py`` (the YAML and
JSON writers, ``.dat`` stores read from joblib and pickle files, the zip
and ``file://`` download helpers), ``utils/image.py``'s padded reads,
``data/``'s samples, ``WSIReader.convert_resolution_units``,
``ModelIOConfigABC.scale_to_highest``/``to_baseline``, the typed dicts'
keys, ``env_detection``, ``type_hints`` and ``ui_utils``. The port's YAML
writer is held to ``yaml.dump`` and its reader to ``yaml.safe_load`` on
hypothesis-drawn documents of the shapes that ``save_yaml`` and IO configs
carry. Results are equal unless a tolerance is stated.
"""

from __future__ import annotations

import json
import pickle
import typing
import zipfile
from pathlib import Path

import joblib
import numpy as np
import pytest
import torch
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import tiatoolbox_tpu.data as jax_data
import tiatoolbox_tpu.type_hints as jax_hints
import tiatoolbox_tpu.utils.env_detection as jax_env
import tiatoolbox_tpu.utils.image as jax_image
import tiatoolbox_tpu.utils.misc as jax_misc
import tiatoolbox_tpu.visualization.ui_utils as jax_ui
import tiatoolbox_tpu_torch.data as port_data
import tiatoolbox_tpu_torch.type_hints as port_hints
import tiatoolbox_tpu_torch.utils.env_detection as port_env
import tiatoolbox_tpu_torch.utils.image as port_image
import tiatoolbox_tpu_torch.utils.misc as port_misc
import tiatoolbox_tpu_torch.visualization.ui_utils as port_ui
from tiatoolbox_tpu import rcParam as jax_rc
from tiatoolbox_tpu_torch import rcParam as port_rc
from tiatoolbox_tpu_torch.utils import yaml_lite

# -- YAML --------------------------------------------------------------------------

_PIECES = list("ab: #-'\"\n\\,[]{}?!&*|>%@`~.0123456789eE+_\t\u00e9 \x85\x00") + [
    "yes", "No", "null", "~", "2001-12-14", "---", "...", "word ", "1.5", "0x1F", "1:20", "0o7", ".inf",
    "CMU-1.svs", "/tmp/slide.tiff", "(0.5, 0.5)", "[1024, 768]", "x" * 70,
]
text = st.lists(st.sampled_from(_PIECES), max_size=30).map("".join)
scalars = st.one_of(st.none(), st.booleans(), st.integers(-(10**20), 10**20), st.floats(allow_nan=False), text)
keys = st.one_of(text.filter(lambda t: 0 < len(t) < 40), st.integers(-1000, 1000))
values = st.recursive(
    scalars, lambda c: st.one_of(st.lists(c, max_size=4), st.dictionaries(keys, c, max_size=4)), max_leaves=12
)
documents = st.one_of(st.dictionaries(keys, values, max_size=5), st.lists(values, max_size=4))


@settings(max_examples=400, suppress_health_check=list(HealthCheck), deadline=None)
@given(documents)
def test_yaml_dump_and_load_against_pyyaml(doc) -> None:
    want = yaml.dump(doc)
    try:
        got = yaml_lite.dump(doc)
    except yaml_lite.YamlLiteError as exc:
        assert "complex" in str(exc)  # PyYAML writes such keys with '?'
        assert "? " in want
        return
    assert got == want
    assert yaml_lite.load(want) == yaml.safe_load(want)


@settings(max_examples=150, suppress_health_check=list(HealthCheck), deadline=None)
@given(
    st.dictionaries(
        st.sampled_from(["objective_power", "slide_dimensions", "mpp", "vendor", "file_path", "axes", "raw"]),
        st.one_of(text, st.tuples(st.floats(0.01, 10), st.floats(0.01, 10)).map(str), st.integers(1, 9).map(str)),
    )
)
def test_save_yaml_writes_jax_text(tmp_path_factory, info) -> None:
    """slide-info's documents: str values (``str()`` of tuples, paths, numbers)."""
    tmp = tmp_path_factory.mktemp("yaml")
    jax_misc.save_yaml(info, tmp / "j.yaml")
    port_misc.save_yaml(info, tmp / "p.yaml")
    assert (tmp / "p.yaml").read_text() == (tmp / "j.yaml").read_text()


@pytest.mark.parametrize(
    "doc",
    [
        {"patch_input_shape": (256, 256), "stride_shape": [(164, 164)], "empty": (), "nested": {"t": (1, [2])}},
        [(1, 2), {"a": ()}],
        {"units": "mpp", "resolution": 0.25, "inf": float("inf"), "big": 1e20, "small": 1e-7},
    ],
)
def test_tuples_tagged_as_yaml_dump_tags_them(doc) -> None:
    assert yaml_lite.dump(doc) == yaml.dump(doc)


@pytest.mark.parametrize(
    "text_in",
    [
        "# io config\ninput_resolutions:\n- {units: mpp, resolution: 0.25}   # comment\n"
        "patch_input_shape: [256, 256]\npatch_output_shape: [164,164]\nsave_resolution: {'units': \"mpp\", resolution: 0.25}\n",
        "---\na: \"multi\n  line \\t text\"\nb: 'it''s\n\n  folded'\nc: plain words\n  continue here\n"
        "d: [1, 2,\n    3, {x: y}]\ne:\nf: ~\ng: yes\nh: 1_000\ni: -.inf\nj: 1:20\nk: 0o17\nl: [ ]\nm: {}\n...\n",
        "- a\n- - b\n  - c\n- k: v\n  k2: [1, 2]\n-\n- 'q'\n",
        "{a: 1, b: [x, y], c: {d: e}}\n",
        "[1, 2.5, true, null, 'x', 0x1f, 0b101, 017, +3, -.5]\n",
        "key: value # with comment\nother: 'x' # c\n",
        "",
    ],
)
def test_yaml_reader_on_config_files(text_in) -> None:
    assert yaml_lite.load(text_in) == yaml.safe_load(text_in)


@pytest.mark.parametrize(
    ("text_in", "what"),
    [
        ("a: &x 1\n", "anchors"),
        ("a: *x\n", "aliases"),
        ("a: !!str 1\n", "tags"),
        ("a: |\n  x\n", "block scalars"),
        ("? a\n: b\n", "complex keys"),
        ("a: 2001-12-14\n", "timestamp"),
        ("a: 1\n---\nb: 2\n", "one document"),
        ("%YAML 1.1\n---\na: 1\n", "directives"),
        ("<<: {a: 1}\n", "merge"),
        ("a:\n\t- 1\n", "tab"),
    ],
)
def test_yaml_reader_refuses_by_name(text_in, what) -> None:
    with pytest.raises(yaml_lite.YamlLiteError, match=what):
        yaml_lite.load(text_in)


def test_yaml_writer_refuses_numpy_scalars() -> None:
    with pytest.raises(yaml_lite.YamlLiteError, match="float64"):
        yaml_lite.dump({"a": np.float64(1.0)})


# -- utils/misc.py ---------------------------------------------------------------------


def test_path_and_string_helpers(tmp_path) -> None:
    for name in ("a.tiff", "b.ome.tiff", "c.png", "d.jpg", "e.tif"):
        (tmp_path / name).write_bytes(b"")
    assert port_misc.split_path_name_ext(tmp_path / "b.ome.tiff") == jax_misc.split_path_name_ext(
        tmp_path / "b.ome.tiff"
    )
    for types in (("*.jpg", "*.png", "*.tif"), "*.tiff,*.png", ("*.svs",)):
        got = sorted(port_misc.grab_files_from_dir(tmp_path, types))
        assert got == sorted(jax_misc.grab_files_from_dir(tmp_path, types))
    assert sorted(port_misc.grab_files_from_dir(tmp_path)) == sorted(jax_misc.grab_files_from_dir(tmp_path))
    for s in ("a, b,c", "single", " x , y "):
        assert port_misc.string_to_tuple(s) == jax_misc.string_to_tuple(s)


@pytest.mark.parametrize(
    "values",
    [[0, 255], [-3, 100], [0, 60000], [-40000, 5], [0, 70000], [-(2**31), 2**31 - 1], [0, 2**33], []],
)
def test_cast_to_min_dtype(values) -> None:
    arr = np.array(values, dtype=np.int64)
    got, want = port_misc.cast_to_min_dtype(arr), jax_misc.cast_to_min_dtype(arr)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("units", ["meter", "m", "centimeter", "cm", "mm", "inch", "in", 2, 3, "furlong"])
def test_ppu2mpp(units) -> None:
    if units == "furlong":
        for fn in (port_misc.ppu2mpp, jax_misc.ppu2mpp):
            with pytest.raises(ValueError, match="Invalid units"):
                fn(1000, units)
        return
    assert port_misc.ppu2mpp(4000.0, units) == jax_misc.ppu2mpp(4000.0, units)


def test_json_and_yaml_files(tmp_path) -> None:
    data = {"a": np.int64(3), "b": np.arange(4).reshape(2, 2), "c": (1.5, np.float32(2.5)), "d": Path("x/y"),
            np.int32(7): [np.bool_(True)]}
    jax_misc.save_as_json(data, tmp_path / "j.json")
    port_misc.save_as_json(data, tmp_path / "p.json")
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    for fn in (jax_misc.save_as_json, port_misc.save_as_json):
        with pytest.raises(FileExistsError):
            fn(data, tmp_path / "p.json")
        fn([1, 2], tmp_path / "deep" / "er" / f"{fn.__module__}.json", parents=True)
    cfg = {"input_resolutions": [{"resolution": 0.25, "units": "mpp"}], "patch_input_shape": [256, 256]}
    jax_misc.save_yaml(cfg, tmp_path / "j.yaml")
    port_misc.save_yaml(cfg, tmp_path / "p.yaml")
    assert (tmp_path / "p.yaml").read_text() == (tmp_path / "j.yaml").read_text()
    with pytest.raises(FileExistsError):
        port_misc.save_yaml(cfg, tmp_path / "p.yaml")
    port_misc.save_yaml(cfg, tmp_path / "p.yaml", exist_ok=True)
    port_misc.save_yaml(cfg, tmp_path / "n" / "p.yaml", parents=True)


def test_zip_and_file_url_download(tmp_path) -> None:
    payload = tmp_path / "payload.bin"
    payload.write_bytes(bytes(range(256)) * 10)
    for name, module in (("jax", jax_misc), ("port", port_misc)):
        got = module.download_data(payload.as_uri(), tmp_path / name / "copy.bin")
        assert got.read_bytes() == payload.read_bytes()
        got.write_bytes(b"kept")
        assert module.download_data(payload.as_uri(), got).read_bytes() == b"kept"
        assert module.download_data(payload.as_uri(), got, overwrite=True).read_bytes() == payload.read_bytes()
        with pytest.raises(ConnectionError, match="Could not download"):
            module.download_data((tmp_path / "missing.bin").as_uri(), tmp_path / name / "no.bin")
        archive = tmp_path / f"{name}.zip"
        with zipfile.ZipFile(archive, "w") as zf:
            zf.writestr("a/b.txt", "hello")
            zf.writestr("c.txt", "world")
        module.unzip_data(archive, tmp_path / f"{name}_out", del_zip=False)
        assert archive.exists()
        module.unzip_data(archive, tmp_path / f"{name}_out2")
        assert not archive.exists()
        assert (tmp_path / f"{name}_out2" / "a" / "b.txt").read_text() == "hello"


def test_select_device_and_zarr(tmp_path, monkeypatch) -> None:
    assert port_misc.select_device(on_gpu=False) == "cpu"
    monkeypatch.setitem(port_rc, "device", "cpu")
    assert port_misc.select_device() == "cpu"
    monkeypatch.setitem(port_rc, "device", "cuda")
    if torch.cuda.is_available():
        assert port_misc.select_device() == port_misc.select_device(on_gpu=True) == "cuda"
    else:
        for on_gpu in (None, True):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                port_misc.select_device(on_gpu=on_gpu)
    from tiatoolbox_tpu.utils.zarrlite import ZarrArray as JaxZarr
    from tiatoolbox_tpu_torch.utils.zarrlite import ZarrArray

    arr = np.random.default_rng(0).random((20, 12)).astype(np.float32)
    ZarrArray.from_array(tmp_path / "z.zarr", arr, chunks=(7, 5))
    got = port_misc.get_zarr_array(ZarrArray(tmp_path / "z.zarr"))
    np.testing.assert_array_equal(got, jax_misc.get_zarr_array(JaxZarr(tmp_path / "z.zarr")))
    lists = [[1, 2], [3, 4]]
    got = port_misc.get_zarr_array(lists)
    want = jax_misc.get_zarr_array(lists)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_load_stain_matrix(tmp_path) -> None:
    matrix = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]])
    np.save(tmp_path / "m.npy", matrix)
    np.savetxt(tmp_path / "m.csv", matrix, delimiter=",")
    for src in (matrix, tmp_path / "m.npy"):
        np.testing.assert_array_equal(port_misc.load_stain_matrix(src), jax_misc.load_stain_matrix(src))
    # the csv: the port parses each value as Python's float() does; JAX's
    # pandas reader (its default C float parser, not correctly rounded) lands
    # up to 2 ulp away on these values
    got = port_misc.load_stain_matrix(str(tmp_path / "m.csv"))
    np.testing.assert_array_equal(got, matrix)
    np.testing.assert_array_max_ulp(got, jax_misc.load_stain_matrix(str(tmp_path / "m.csv")), maxulp=2)
    with pytest.raises(Exception, match="npy or a csv"):
        port_misc.load_stain_matrix(tmp_path / "m.txt")


def _poly_rows(store) -> list:
    rows = []
    for ann in store.values():
        rows.append((json.dumps(ann.properties, sort_keys=True), np.round(np.asarray(ann.geometry.coords, float), 9)))
    return sorted(rows, key=lambda r: (r[0], r[1].ravel().tolist()))


def _hover_dict(rng, n: int, offset: float = 0.0) -> dict:
    out = {}
    for k in range(n):
        x, y = rng.uniform(0, 200, 2) + offset
        contour = np.array([[x, y], [x + 8, y], [x + 9, y + 7], [x, y + 8]])
        out[f"id{k}"] = {"box": np.array([x, y, x + 9, y + 8]), "centroid": contour.mean(axis=0),
                         "contour": contour, "prob": float(rng.uniform()), "type": int(k % 3)}
    # a degenerate (flat) contour is repaired with a buffer in both
    out["flat"] = {"box": np.zeros(4), "centroid": np.zeros(2), "contour": np.array([[0, 0], [5, 0], [9, 0]]),
                   "prob": 0.5, "type": 1}
    return out


@pytest.mark.parametrize("writer", ["joblib", "pickle", "joblib_cerberus", "resolutions"])
def test_dat_files_to_stores(tmp_path, writer) -> None:
    from tiatoolbox_tpu.annotation.storage import SQLiteStore as JaxStore
    from tiatoolbox_tpu_torch.annotation.storage import SQLiteStore

    rng = np.random.default_rng(3)
    data = _hover_dict(rng, 12)
    typedict = None
    if writer == "joblib_cerberus":
        data = {"nuclei": _hover_dict(rng, 6), "gland": _hover_dict(rng, 4, 300.0), "resolution": 0.5}
    elif writer == "resolutions":
        data["base_resolution"] = {"resolution": 0.25}
        data["proc_resolution"] = {"resolution": 0.5}
        data = dict(data)
        typedict = {0: "a", 1: "b", 2: "c"}
    path = tmp_path / "x.dat"
    if writer == "pickle":
        path.write_bytes(pickle.dumps(data))
    else:
        joblib.dump(data, path)
    if writer == "resolutions":
        # JAX's reads every key as an instance; both refuse the dict alike
        for fn in (jax_misc.store_from_dat, port_misc.store_from_dat):
            with pytest.raises(KeyError):
                fn(path, typedict=typedict)
        return
    kwargs = {"scale_factor": (2, 2), "origin": (5.0, 3.0)}
    got = port_misc.store_from_dat(path, **kwargs)
    want = jax_misc.store_from_dat(path, cls=JaxStore, **kwargs)
    assert isinstance(got, SQLiteStore)
    assert len(got) == len(want) > 0
    got_rows, want_rows = _poly_rows(got), _poly_rows(want)
    for (gp, gc), (wp, wc) in zip(got_rows, want_rows, strict=True):
        assert gp == wp
        np.testing.assert_allclose(gc, wc, atol=1e-9)
    if writer == "joblib_cerberus":
        assert port_misc.make_default_dict(data, "nuclei") == jax_misc.make_default_dict(data, "nuclei")
    assert port_misc.save_annotations(tmp_path / "s.sqlite", got).suffix == ".db"
    qp = {"type": "FeatureCollection", "features": []}
    out = port_misc.save_qupath_json(tmp_path / "q.geojson", qp)
    jax_out = jax_misc.save_qupath_json(tmp_path / "jq.geojson", qp)
    assert out.suffix == ".json" and out.read_text() == jax_out.read_text()


def test_compressed_joblib_refused_by_name(tmp_path) -> None:
    joblib.dump({"a": np.arange(3)}, tmp_path / "c.dat", compress=3)
    with pytest.raises(Exception, match="compressed joblib"):
        port_misc.store_from_dat(tmp_path / "c.dat")


def test_make_valid_poly() -> None:
    from tiatoolbox_tpu.annotation.geometry import Polygon as JaxPolygon
    from tiatoolbox_tpu_torch.annotation.geometry import Polygon

    shells = [np.array([[0, 0], [10, 0], [10, 5], [0, 5]], float), np.array([[0, 0], [4, 0], [8, 0]], float)]
    for shell in shells:
        for origin in (None, (0, 0), (2.5, -1.0)):
            got = port_misc.make_valid_poly(Polygon(shell), origin)
            want = jax_misc.make_valid_poly(JaxPolygon(shell), origin)
            np.testing.assert_allclose(np.asarray(got.coords, float), np.asarray(want.coords, float), atol=1e-12)


# -- utils/image.py ----------------------------------------------------------------------


@pytest.mark.parametrize(
    ("bounds", "padding", "stride", "pad_mode"),
    [
        ((2, 3, 12, 10), 0, 1, "constant"),
        ((-4, -2, 8, 9), 0, 1, "constant"),
        ((10, 10, 30, 25), 2, 1, "reflect"),
        ((-3, 5, 18, 30), (1, 3), 2, "edge"),
        ((0, 0, 20, 16), 0, (2, 3), "constant"),
        ((-5, -5, 25, 21), 1, 1, None),
        ((-5, -5, 25, 21), 3, 1, "wrap"),
    ],
)
def test_safe_padded_read(bounds, padding, stride, pad_mode) -> None:
    image = np.random.default_rng(1).integers(0, 255, (16, 20, 3), dtype=np.uint8)
    b = np.array(bounds)
    got = port_image.safe_padded_read(image, b, stride=stride, padding=padding, pad_mode=pad_mode, pad_constant_values=7)
    want = jax_image.safe_padded_read(image, b, stride=stride, padding=padding, pad_mode=pad_mode, pad_constant_values=7)
    np.testing.assert_array_equal(got, want)


def test_safe_padded_read_refusals() -> None:
    image = np.zeros((8, 8), np.uint8)
    for kwargs, exc in (({"bounds": np.array([0.5, 0, 4, 4])}, TypeError),
                        ({"bounds": np.array([0, 0, 4, 4]), "padding": -1}, ValueError),
                        ({"bounds": np.array([0, 0, 4, 4]), "stride": (1, 2, 3)}, ValueError)):
        for fn in (port_image.safe_padded_read, jax_image.safe_padded_read):
            with pytest.raises(exc):
                fn(image, **kwargs)


@pytest.mark.parametrize(
    ("bounds", "pad_mode"),
    [((2, 2, 10, 10), "constant"), ((-4, -3, 12, 9), "constant"), ((5, 6, 30, 24), "edge"), ((-2, -2, 4, 4), None)],
)
def test_crop_and_pad_edges(bounds, pad_mode) -> None:
    region = np.random.default_rng(2).integers(0, 255, (bounds[3] - bounds[1], bounds[2] - bounds[0], 3)).astype(np.uint8)
    got = port_image.crop_and_pad_edges(bounds, (20, 16), region, pad_mode=pad_mode, pad_constant_values=9)
    want = jax_image.crop_and_pad_edges(bounds, (20, 16), region, pad_mode=pad_mode, pad_constant_values=9)
    np.testing.assert_array_equal(got, want)


def test_conv_out_size() -> None:
    for args in ((np.array([10, 17]), 3, 1, 2), (np.array([224]), 7, 3, 2), (np.array([5, 6]), 1, 0, 1)):
        np.testing.assert_array_equal(port_image.conv_out_size(*args), jax_image.conv_out_size(*args))


# -- data/, wsicore, io configs ------------------------------------------------------------


@pytest.fixture
def homes(tmp_path):
    old = jax_rc["TIATOOLBOX_HOME"], port_rc["TIATOOLBOX_HOME"]
    jax_rc["TIATOOLBOX_HOME"], port_rc["TIATOOLBOX_HOME"] = str(tmp_path / "jax"), tmp_path / "port"
    yield tmp_path
    jax_rc["TIATOOLBOX_HOME"], port_rc["TIATOOLBOX_HOME"] = old


def test_stain_norm_target_within_one_level() -> None:
    got, want = port_data.stain_norm_target(), jax_data.stain_norm_target()
    assert got.shape == want.shape == (224, 224, 3) and got.dtype == want.dtype
    assert np.abs(got.astype(int) - want).max() <= 1


def test_sample_slides(homes) -> None:
    from tiatoolbox_tpu.wsicore.wsireader import WSIReader as JaxReader
    from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader

    for fn in ("small_svs", "sample_slide_path"):
        got, want = getattr(port_data, fn)(), getattr(jax_data, fn)()
        assert got.name == want.name and got.parent == homes / "port" / "samples"
        assert getattr(port_data, fn)() == got  # cached
        a, b = WSIReader.open(got).info, JaxReader.open(want).info
        assert (a.slide_dimensions, a.level_count, tuple(a.mpp), a.objective_power) == (
            b.slide_dimensions, b.level_count, tuple(b.mpp), b.objective_power)


@pytest.mark.parametrize("key", ["svs-1-small", "dicom-1", "jp2-omnyx-small", "stainnorm-source", "sample-patch-1"])
def test_remote_sample_stand_ins(homes, key) -> None:
    from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader

    path = port_data._fetch_remote_sample(key, homes / "remote")  # noqa: SLF001
    assert path.exists() and path.parent == homes / "remote"
    assert port_data.REMOTE_SAMPLES.keys() == yaml.safe_load(
        (Path(jax_data.__file__).parent / "remote_samples.yaml").read_text())["files"].keys()
    if path.suffix == ".png":
        assert port_misc.imread(path).shape == (224, 224, 3)
    else:
        reader = WSIReader.open(path)
        assert reader.read_rect((0, 0), (32, 32)).shape == (32, 32, 3)
    with pytest.raises(KeyError, match="Unknown remote sample"):
        port_data._fetch_remote_sample("nope")  # noqa: SLF001


def test_wsireader_params_keys() -> None:
    from tiatoolbox_tpu.wsicore import WSIReaderParams as JaxParams
    from tiatoolbox_tpu_torch.wsicore import WSIReaderParams

    assert WSIReaderParams.__annotations__.keys() == JaxParams.__annotations__.keys()
    assert WSIReaderParams.__total__ is False


@pytest.fixture(scope="module")
def readers(tmp_path_factory):
    from tiatoolbox_tpu.wsicore.wsireader import WSIReader as JaxReader
    from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide
    from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader, VirtualWSIReader

    path = tmp_path_factory.mktemp("cru") / "s.tiff"
    make_synthetic_slide(path, size=(512, 384), mpp=0.5, objective_power=20, compression="deflate")
    from tiatoolbox_tpu.wsicore.wsireader import VirtualWSIReader as JaxVirtual

    bare = np.zeros((64, 64, 3), np.uint8)
    return [(WSIReader.open(path), JaxReader.open(path)), (VirtualWSIReader(bare), JaxVirtual(bare))]


@pytest.mark.parametrize(
    ("res", "unit", "out"),
    [(0.25, "mpp", None), ((0.5, 1.0), "mpp", "baseline"), (10, "power", None), (40, "power", "mpp"),
     (1, "level", None), (0, "level", "power"), (0.5, "baseline", None), (2.0, "baseline", "mpp")],
)
def test_convert_resolution_units(readers, res, unit, out) -> None:
    port_reader, jax_reader = readers[0]
    got = port_reader.convert_resolution_units(res, unit, out)
    want = jax_reader.convert_resolution_units(res, unit, out)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k], float), np.asarray(want[k], float))
    else:
        np.testing.assert_array_equal(np.asarray(got, float), np.asarray(want, float))


@pytest.mark.parametrize(("unit", "out"), [("furlong", None), ("mpp", "level"), ("mpp", None), ("power", None)])
def test_convert_resolution_units_refusals(readers, unit, out) -> None:
    port_reader, jax_reader = readers[1]  # no mpp, no power
    for reader in (port_reader, jax_reader):
        with pytest.raises(ValueError) as err:
            reader.convert_resolution_units(1.0, unit, out)
        assert err.value.args


@pytest.mark.parametrize(
    "name", ["resnet18-kather100k", "hovernet_fast-pannuke", "fcn_resnet50_unet-bcss", "mapde-conic", "sccnn-crchisto"]
)
def test_scale_to_highest_and_to_baseline(name) -> None:
    from tiatoolbox_tpu import _get_pretrained_info
    from tiatoolbox_tpu.models.engine import io_config as jax_io
    from tiatoolbox_tpu_torch import PRETRAINED_MODELS
    from tiatoolbox_tpu_torch.models.engine import io_config as port_io

    port_cfg = PRETRAINED_MODELS[name]["ioconfig"]
    jax_cfg = _get_pretrained_info()[name]["ioconfig"]
    got = getattr(port_io, port_cfg["class"])(**port_cfg["kwargs"]).to_baseline()
    want = getattr(jax_io, jax_cfg["class"])(**jax_cfg["kwargs"]).to_baseline()
    assert type(got).__name__ == type(want).__name__
    for attr in ("input_resolutions", "output_resolutions", "save_resolution", "resolution_unit"):
        assert getattr(got, attr, None) == getattr(want, attr, None), attr
    res = [{"units": "mpp", "resolution": r} for r in (0.25, 0.5, 1.0)]
    for units in ("mpp", "power", "baseline"):
        np.testing.assert_array_equal(port_io.ModelIOConfigABC.scale_to_highest(res, units),
                                      jax_io.ModelIOConfigABC.scale_to_highest(res, units))
    with pytest.raises(ValueError, match="Unknown units"):
        port_io.ModelIOConfigABC.scale_to_highest(res, "level")


# -- models ------------------------------------------------------------------------------


def test_load_torch_model_and_model_to(tmp_path, monkeypatch) -> None:
    from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNModel
    from tiatoolbox_tpu_torch.models.models_abc import load_torch_model, model_to

    torch.manual_seed(0)
    src = CNNModel("resnet18", num_classes=3, device="cpu")
    torch.save(src.state_dict(), tmp_path / "w.pth")
    dst = CNNModel("resnet18", num_classes=3, device="cpu")
    assert load_torch_model(dst, tmp_path / "w.pth") is dst
    for key, value in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[key], value, rtol=0, atol=0)
    assert model_to(dst, "cpu") is dst
    monkeypatch.setitem(port_rc, "device", "cpu")
    assert model_to(dst) is dst
    monkeypatch.setitem(port_rc, "device", "cuda")
    if not torch.cuda.is_available():
        for device in ("cuda", None):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                model_to(dst, device)


def test_compile_model_modes() -> None:
    from tiatoolbox_tpu.models.architecture.utils import compile_model as jax_compile
    from tiatoolbox_tpu_torch.models.architecture.utils import compile_model, is_torch_compile_compatible

    model = torch.nn.Linear(2, 2)
    for fn in (compile_model, jax_compile):
        with pytest.raises(ValueError, match="Invalid mode"):
            fn(model, mode="fastest")
        assert fn(model, mode="disable") is model
    if not torch.cuda.is_available():
        assert is_torch_compile_compatible() is False
        assert compile_model(model) is model


def test_run_params_keys() -> None:
    """The typed dicts' keys are the port's run parameters; against JAX's the
    differences are the relay and drain options and ``output_type``."""
    from tiatoolbox_tpu.models.engine.multi_task_segmentor import MultiTaskSegmentor as JaxMT
    from tiatoolbox_tpu.models.engine.nucleus_detector import NucleusDetector as JaxND
    from tiatoolbox_tpu.models.engine.patch_predictor import PatchPredictor as JaxPP
    from tiatoolbox_tpu.models.engine.semantic_segmentor import SemanticSegmentor as JaxSS
    from tiatoolbox_tpu_torch.models.engine.engine_abc import EngineABC, EngineABCRunParams
    from tiatoolbox_tpu_torch.models.engine.multi_task_segmentor import MultiTaskSegmentor, MultiTaskSegmentorRunParams
    from tiatoolbox_tpu_torch.models.engine.nucleus_detector import NucleusDetector, NucleusDetectorRunParams
    from tiatoolbox_tpu_torch.models.engine.patch_predictor import PatchPredictor, PredictorRunParams
    from tiatoolbox_tpu_torch.models.engine.semantic_segmentor import SemanticSegmentor, SemanticSegmentorRunParams

    jax_only = {"output_type", "transfer_threads", "drain_during_loop"}
    for typed, engine, jax_engine in (
        (EngineABCRunParams, EngineABC, None),
        (PredictorRunParams, PatchPredictor, JaxPP),
        (SemanticSegmentorRunParams, SemanticSegmentor, JaxSS),
        (MultiTaskSegmentorRunParams, MultiTaskSegmentor, JaxMT),
        (NucleusDetectorRunParams, NucleusDetector, JaxND),
    ):
        assert typed.__total__ is False
        assert tuple(typing.get_type_hints(typed)) == engine._RUN_PARAMS  # noqa: SLF001
        if jax_engine is not None:
            assert set(engine._RUN_PARAMS) == set(jax_engine._RUN_PARAMS) - jax_only  # noqa: SLF001


# -- environment, type hints, ui -----------------------------------------------------------


def test_env_detection(monkeypatch) -> None:
    assert port_env.has_tpu() is False
    assert port_env.has_gpu() is torch.cuda.is_available()
    assert port_env.device_count() == torch.cuda.device_count()
    names = ["running_on_ci", "is_interactive", "is_notebook", "in_conda_env", "running_on_github",
             "running_on_circleci", "running_on_travis", "running_on_kaggle", "running_on_colab", "colab_has_gpu"]
    env_sets = [{}, {"CI": "1"}, {"GITHUB_ACTIONS": "true"}, {"CIRCLECI": "true", "TRAVIS": "true"},
                {"KAGGLE_KERNEL_RUN_TYPE": "x", "COLAB_GPU": "1"}, {"CONDA_DEFAULT_ENV": "a", "CONDA_PREFIX": "/c"},
                {"COLAB_RELEASE_TAG": "r", "COLAB_GPU": "0"}]
    all_keys = {k for env in env_sets for k in env}
    for env in env_sets:
        for key in all_keys:
            monkeypatch.delenv(key, raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        for name in names:
            assert getattr(port_env, name)() == getattr(jax_env, name)(), (name, env)
    for v in ("1.2.3", "2.11.0+cu128", "0.9", "abc", "3.12.3rc1", "10..2"):
        assert port_env.version_to_tuple(v) == jax_env.version_to_tuple(v)
    # a closed port on this host: no outside host is contacted
    assert port_env.has_network("127.0.0.1", timeout=0.5) == jax_env.has_network("127.0.0.1", timeout=0.5)


def test_type_hints_names() -> None:
    public = lambda m: {k for k in vars(m) if not k.startswith("_") and k[0].isupper()}  # noqa: E731
    assert public(port_hints) == public(jax_hints)
    assert port_hints.Units == jax_hints.Units
    assert port_hints.NumpyPadLiteral == jax_hints.NumpyPadLiteral


def test_ui_utils() -> None:
    assert port_ui.resolutions == jax_ui.resolutions
    rng = np.random.default_rng(5)
    for _ in range(200):
        x0, y0 = rng.uniform(0, 1e5, 2)
        w, h = 10 ** rng.uniform(-1, 6, 2)
        extent = (x0, y0, x0 + w, y0 + h)
        assert port_ui.get_level_by_extent(extent) == jax_ui.get_level_by_extent(extent)
