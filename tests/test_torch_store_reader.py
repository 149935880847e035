"""``AnnotationStoreReader``: the port against the JAX package.

Tolerance: none. A seeded SQLite store of polygons, points and lines is
read as a slide by both packages, alone (composited onto white) and over a
seeded base slide with ``alpha``, through ``WSIReader.open(".db")`` and the
constructor: ``read_rect``, ``read_bounds`` at baseline, at power-of-two
resolutions, and the thumbnail are equal arrays. A read at a scale that is
not a power of two (0.7) shrinks the baseline render to its output size
with ``imresize``'s "optimise", which is OpenCV's cubic there (JAX's rule),
and cv2 runs Intel IPP's cubic, which the port reproduces but for about one
value in 10^5 (``ROADMAP.md`` section 3): that read is held to its count
of values one level apart (``IPP_CUBIC_DIFFERING``).
"""

from __future__ import annotations

import numpy as np
import pytest

from tiatoolbox_tpu.annotation import geometry as jax_geometry
from tiatoolbox_tpu.annotation import storage as jax_storage
from tiatoolbox_tpu.data.synth import synthetic_he_patch
from tiatoolbox_tpu.utils import visualization as jax_vis
from tiatoolbox_tpu.wsicore import store_reader as jax_store_reader
from tiatoolbox_tpu.wsicore import wsimeta as jax_wsimeta
from tiatoolbox_tpu.wsicore import wsireader as jax_wsireader
from tiatoolbox_tpu_torch.annotation import geometry as port_geometry
from tiatoolbox_tpu_torch.annotation import storage as port_storage
from tiatoolbox_tpu_torch.utils import visualization as port_vis
from tiatoolbox_tpu_torch.wsicore import store_reader as port_store_reader
from tiatoolbox_tpu_torch.wsicore import wsimeta as port_wsimeta
from tiatoolbox_tpu_torch.wsicore import wsireader as port_wsireader

W, H = 800, 600


def _write_store(path) -> None:
    """One store file, written by the port (both packages read it)."""
    rng = np.random.default_rng(11)
    store = port_storage.SQLiteStore(path)
    for i in range(150):
        cx, cy = rng.uniform(0, W, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 9))
        rad = rng.uniform(4, 30, 9)
        shell = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
        store.append(port_storage.Annotation(port_geometry.Polygon(shell), {"type": i % 4, "prob": float(rng.uniform())}))
    store.append(port_storage.Annotation(port_geometry.Point(400, 300), {"type": 9}))
    store.append(port_storage.Annotation(port_geometry.LineString([(0, 590), (790, 20)]), {"type": 8}))
    store.commit()
    store.close()


def _base(tmp_path):
    img = synthetic_he_patch((W, H), seed=4)
    path = tmp_path / "base.npy"
    np.save(path, img)
    return path


@pytest.fixture()
def db(tmp_path):
    path = tmp_path / "store.db"
    _write_store(path)
    return path


# values of the 0.7 read one level from cv2's, by case: alone, over the base at alpha 0.5, 1.0
IPP_CUBIC_DIFFERING = {None: 19, 0.5: 3, 1.0: 4}


def _assert_read(got: np.ndarray, want: np.ndarray, kwargs: dict, alpha: float | None = None) -> None:
    assert got.shape == want.shape
    if kwargs.get("resolution", 1.0) == 0.7:
        diff = np.abs(got.astype(int) - want)
        assert diff.max() <= 1
        assert np.count_nonzero(diff) <= IPP_CUBIC_DIFFERING[alpha]
    else:
        np.testing.assert_array_equal(got, want)


READS = [
    ("read_rect", ((0, 0), (256, 256)), {}),
    ("read_rect", ((100, 50), (300, 200)), {}),
    ("read_bounds", ((64, 32, 576, 544),), {"resolution": 0.5, "units": "baseline"}),
    ("read_bounds", ((0, 0, 800, 600),), {"resolution": 0.25, "units": "baseline"}),
    ("read_bounds", ((10, 10, 410, 310),), {"resolution": 0.7, "units": "baseline"}),
]


@pytest.mark.parametrize(("method", "args", "kwargs"), READS)
def test_store_alone(db, method, args, kwargs) -> None:
    jax_reader = jax_wsireader.WSIReader.open(db)
    port_reader = port_wsireader.WSIReader.open(db)
    assert type(port_reader).__name__ == type(jax_reader).__name__ == "AnnotationStoreReader"
    assert port_reader.info.slide_dimensions == jax_reader.info.slide_dimensions
    want = getattr(jax_reader, method)(*args, **kwargs)
    got = getattr(port_reader, method)(*args, **kwargs)
    _assert_read(got, want, kwargs)


@pytest.mark.parametrize(("method", "args", "kwargs"), READS)
@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_store_over_base(db, tmp_path, method, args, kwargs, alpha: float) -> None:
    base = _base(tmp_path)
    renderer_kwargs = {"score_prop": "prob", "mapper": "jet", "edge_thickness": 2}
    jax_reader = jax_store_reader.AnnotationStoreReader(
        db, base_wsi=base, alpha=alpha, renderer=jax_vis.AnnotationRenderer(**renderer_kwargs)
    )
    port_reader = port_store_reader.AnnotationStoreReader(
        db, base_wsi=base, alpha=alpha, renderer=port_vis.AnnotationRenderer(**renderer_kwargs)
    )
    want = getattr(jax_reader, method)(*args, **kwargs)
    got = getattr(port_reader, method)(*args, **kwargs)
    _assert_read(got, want, kwargs, alpha)


def test_thumbnail_and_info(db, tmp_path) -> None:
    base = _base(tmp_path)
    jax_reader = jax_store_reader.AnnotationStoreReader(db, base_wsi=base, alpha=0.5)
    port_reader = port_store_reader.AnnotationStoreReader(db, base_wsi=base, alpha=0.5)
    assert port_reader.info.slide_dimensions == jax_reader.info.slide_dimensions == (W, H)
    np.testing.assert_array_equal(
        port_reader.slide_thumbnail(resolution=0.125, units="baseline"),
        jax_reader.slide_thumbnail(resolution=0.125, units="baseline"),
    )


def test_in_memory_store_and_given_info() -> None:
    """A store object (not a path) with a given ``WSIMeta``; an empty store is 1024 square."""
    def build(geometry, storage, meta, module):
        store = storage.DictionaryStore()
        store.append(storage.Annotation(geometry.Polygon.from_bounds(50, 50, 200, 200), {"type": "x"}))
        info = meta.WSIMeta(slide_dimensions=(300, 260), axes="YXS", level_dimensions=[(300, 260)],
                            level_downsamples=[1.0], raw=None)
        return module.AnnotationStoreReader(store, info=info), module.AnnotationStoreReader(storage.DictionaryStore())

    jax_readers = build(jax_geometry, jax_storage, jax_wsimeta, jax_store_reader)
    port_readers = build(port_geometry, port_storage, port_wsimeta, port_store_reader)
    np.testing.assert_array_equal(port_readers[0].read_rect((0, 0), (300, 260)), jax_readers[0].read_rect((0, 0), (300, 260)))
    assert port_readers[1].info.slide_dimensions == jax_readers[1].info.slide_dimensions == (1024, 1024)


def test_reader_tile_is_the_generator_tile(db, tmp_path) -> None:
    """What the smoke checks on the card machine: a baseline tile read through
    ``AnnotationStoreReader`` without a base is ``AnnotationTileGenerator.get_tile``
    composited onto white (one renderer: categorical colours go by first sight)."""
    from tiatoolbox_tpu_torch.tools.pyramid import AnnotationTileGenerator
    from tiatoolbox_tpu_torch.utils.transforms import background_composite

    info = port_wsireader.WSIReader.open(_base(tmp_path)).info
    renderer = port_vis.AnnotationRenderer()
    reader = port_store_reader.AnnotationStoreReader(db, info=info, renderer=renderer)
    gen = AnnotationTileGenerator(info, reader.store, renderer=renderer)
    top = gen.level_count - 1
    for x, y in [(0, 0), (1, 1), (2, 0), (1, 0)]:  # tiles inside the 800 x 600 slide
        want = background_composite(gen.get_tile(top, x, y), alpha=False)
        np.testing.assert_array_equal(reader.read_rect((x * 256, y * 256), (256, 256)), want)
