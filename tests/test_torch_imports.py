"""The port runs where only torch, numpy and scipy are installed.

A subprocess installs a ``sys.meta_path`` finder that refuses jax, flax,
cv2, yaml, PIL, pandas, tqdm, psutil, sklearn, fsspec, matplotlib and the
JAX package, imports every
module of ``tiatoolbox_tpu_torch`` and ``chip_smoke``, and runs the slices
(stain transform, bench config 2's mask and sliding-window extraction,
whole-slide patch classification, whole-slide semantic segmentation and
whole-slide nucleus instance segmentation, which build and load the host
C++ libraries: the JPEG codec of the slide's tiles, the watershed) on the
CPU on a tiny JPEG slide, and saves the results in every output type (the
contour tracer's C++, sqlite3, the colour tables); then nucleus detection
with SCCNN and HoVer-Net+'s layer post-processing; then the classifier zoo
(MobileNetV3, an IDaRS entry) and feature extraction (DenseNet and
EfficientNet features to zarr, a narrow ViT); then the registry's tail
(KongNet on the detector, GrandQC's JPEG round trip and EfficientUNet's
morphology on the semantic engine, NuClick with a click); then the stain
API's Reinhard and Vahadane normalisers and stain augmentation, and the
readers on the port's own codecs (MIRAX, JPEG DICOM, NGFF, an fsspec
reference, a PNG slide, a tiled JPEG 2000 slide through the JPEG 2000
codec's C++); then SAM from a checkpoint directory written with numpy
(transformers, safetensors and huggingface_hub refused too) and
PromptSegmentor with a point and a box; then registration (prealignment,
DFBR, B-spline steps, a read through the transform); then rendering (an
annotation store opened as a slide over the slide, an annotation pyramid
to a zip and a Zoomify pyramid to a tar through the rasteriser's C++, an
overlay written as PNG and JPEG, the golden sets replayed), the slide
graph with UMAP colours drawn by ``plot_graph``, and the Kather stand-in;
then the CLI (``version``, ``slide-info`` to YAML, ``save-tiles``) and the
tile server on a thread (a slide tile and a store tile over HTTP, then
``/tileserver/shutdown``), with click and joblib refused too.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

GUARDED_RUN = textwrap.dedent(
    """
    import importlib, pkgutil, sys, tempfile
    from importlib.abc import MetaPathFinder

    BLOCKED = {"jax", "jaxlib", "flax", "cv2", "yaml", "PIL", "pandas", "tqdm",
               "psutil", "sklearn", "fsspec", "matplotlib", "transformers", "safetensors",
               "huggingface_hub", "click", "joblib", "tiatoolbox_tpu"}

    class Refuse(MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"import of {name} refused")
            return None

    sys.meta_path.insert(0, Refuse())
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]

    import numpy as np
    import torch
    import tiatoolbox_tpu_torch

    torch.set_num_threads(2)
    names = [m.name for m in pkgutil.walk_packages(
        tiatoolbox_tpu_torch.__path__, "tiatoolbox_tpu_torch.")]
    for name in names + ["chip_smoke"]:
        importlib.import_module(name)

    from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide, synthetic_he_patch
    from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNModel
    from tiatoolbox_tpu_torch.models.engine.io_config import IOPatchPredictorConfig
    from tiatoolbox_tpu_torch.models.engine.patch_predictor import PatchPredictor
    from tiatoolbox_tpu_torch.tools.stainnorm import get_normalizer
    from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader

    with tempfile.TemporaryDirectory() as tmp:
        slide = make_synthetic_slide(f"{tmp}/slide.tiff", size=(512, 384), seed=3)
        reader = WSIReader.open(slide)
        from tiatoolbox_tpu_torch.tools.patchextraction import get_patch_extractor

        mask = reader.tissue_mask(method="morphological", resolution=8.0, units="mpp")
        extractor = get_patch_extractor("slidingwindow", input_img=reader, input_mask=mask,
                                        patch_size=(64, 64), stride=(64, 64), resolution=0.5,
                                        units="mpp", min_mask_ratio=0.1)
        assert len(extractor) > 0 and next(iter(extractor)).shape == (64, 64, 3)
        norm = get_normalizer("macenko")
        norm.fit(synthetic_he_patch((96, 96), seed=4))
        constants = norm.prepare_tile_transform(reader.slide_thumbnail(resolution=5, units="power"))
        tiles = np.stack([reader.read_rect((0, 0), (64, 64))] * 2)
        out = norm.transform_tiles(tiles, constants, device="cpu")
        assert out.shape == tiles.shape and out.dtype == torch.uint8
        io = IOPatchPredictorConfig(input_resolutions=[{"units": "mpp", "resolution": 0.5}],
                                    patch_input_shape=(128, 128), stride_shape=(128, 128))
        result = PatchPredictor(model=CNNModel("resnet18", num_classes=9, device="cpu"), batch_size=4,
                                verbose=False, device="cpu").run([slide], patch_mode=False, ioconfig=io)
        probs = result[str(slide)]["probabilities"]
        assert probs.shape[1] == 9 and np.allclose(probs.sum(axis=1), 1, atol=1e-4)

        from tiatoolbox_tpu_torch.models.architecture.unet import UNetModel
        from tiatoolbox_tpu_torch.models.engine import IOSegmentorConfig, SemanticSegmentor

        unet = UNetModel(3, 2, encoder="unet", encoder_levels=[8, 16], device="cpu")
        seg_io = IOSegmentorConfig(input_resolutions=[{"units": "mpp", "resolution": 0.5}],
                                   output_resolutions=[{"units": "mpp", "resolution": 0.5}],
                                   patch_input_shape=(64, 64), patch_output_shape=(32, 32),
                                   stride_shape=(24, 24))
        segmentor = SemanticSegmentor(unet, batch_size=4, verbose=False, device="cpu")
        seg = segmentor.run([slide], patch_mode=False, ioconfig=seg_io, auto_get_mask=False)
        assert seg[str(slide)]["predictions"].shape == (384, 512)
        assert segmentor.last_stage_summary["path"] == "device-canvas+region-feed"
        # the writers: zarr, the AnnotationStore (the native contour tracer),
        # QuPath JSON and the OME-TIFF heatmap (the colour tables)
        for kind, name in (("zarr", "s.zarr"), ("annotationstore", "s.db"), ("qupath", "s.json"),
                           ("ome-tiff", "s.ome.tiff")):
            written = segmentor.save_predictions(seg[str(slide)], kind, tmp, output_file=name)
            assert written.exists(), kind
        from tiatoolbox_tpu_torch.utils.misc import write_probability_heatmap_as_ome_tiff

        write_probability_heatmap_as_ome_tiff(f"{tmp}/jet.ome.tiff", seg[str(slide)]["probabilities"][..., 1], 2)

        from tiatoolbox_tpu_torch.models.architecture import get_pretrained_model
        from tiatoolbox_tpu_torch.models.architecture.hovernet_checkpoint import (
            functional_hovernet_state_dict,
        )
        from tiatoolbox_tpu_torch.models.engine import MultiTaskSegmentor

        small = make_synthetic_slide(f"{tmp}/nuclei.tiff", size=(164, 164), mpp=0.25,
                                     objective_power=40, seed=5)
        hovernet, hv_io = get_pretrained_model("hovernet_fast-pannuke", device="cpu")
        hovernet.load_state_dict(functional_hovernet_state_dict())
        nuclei_engine = MultiTaskSegmentor(hovernet, batch_size=2, verbose=False, device="cpu")
        nuclei = nuclei_engine.run([small], patch_mode=False, ioconfig=hv_io, auto_get_mask=False)
        assert len(nuclei[str(small)]["instances"]) > 0
        from tiatoolbox_tpu_torch.annotation.storage import SQLiteStore

        db = nuclei_engine.save_predictions(nuclei[str(small)], "annotationstore", tmp, output_file="nuclei.db")
        assert len(SQLiteStore(db)) == len(nuclei[str(small)]["instances"])

        # nucleus detection (SCCNN on a tiny slide, its points in a store) and
        # HoVer-Net+'s layer post-processing (the box morphology, the tree contours)
        from tiatoolbox_tpu_torch.models.architecture.hovernetplus import HoVerNetPlus
        from tiatoolbox_tpu_torch.models.engine import NucleusDetector

        sccnn, sccnn_io = get_pretrained_model("sccnn-crchisto", device="cpu")
        detector = NucleusDetector(sccnn, batch_size=16, verbose=False, device="cpu")
        detections = detector.run([small], patch_mode=False, ioconfig=sccnn_io, auto_get_mask=False,
                                  threshold_abs=0.0)[str(small)]
        assert len(detections["coordinates"]) > 0
        db = detector.save_predictions(detections, "annotationstore", tmp, output_file="points.db")
        assert len(SQLiteStore(db)) == len(detections["coordinates"])
        layers = np.zeros((300, 300, 1), np.float32)
        layers[20:280, 20:280] = 1
        layers[60:260, 40:240] = 3
        layers[120:160, 120:160] = 1
        cleaned = HoVerNetPlus._proc_ls(layers)
        assert set(np.unique(cleaned)) == {0, 1, 3}
        assert [v["type"] for v in HoVerNetPlus._get_layer_info(cleaned).values()] == [1, 1, 1, 3, 3]

        # the classifier zoo (a non-ResNet backbone, an idars entry's float
        # patches) and feature extraction (a CNN, EfficientNet and a narrow ViT
        # encoder; the features saved to zarr)
        from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNBackbone
        from tiatoolbox_tpu_torch.models.architecture.vit import TimmBackbone
        from tiatoolbox_tpu_torch.models.engine import DeepFeatureExtractor
        from tiatoolbox_tpu_torch.utils.zarrlite import open_zarr

        zoo = PatchPredictor(model=CNNModel("mobilenet_v3_small", num_classes=2, device="cpu"), batch_size=4,
                             verbose=False, device="cpu").run([slide], patch_mode=False, ioconfig=io)
        assert zoo[str(slide)]["probabilities"].shape[1] == 2
        idars, _ = get_pretrained_model("resnet18-idars-msi", device="cpu")
        patches = np.stack([reader.read_rect((0, 0), (64, 64))] * 3)
        assert PatchPredictor(model=idars, batch_size=2, verbose=False, device="cpu").run(
            patches)["probabilities"].shape == (3, 2)
        for extractor in (CNNBackbone("densenet121", device="cpu"), TimmBackbone("efficientnet_b0", device="cpu")):
            written = DeepFeatureExtractor(extractor, batch_size=4, verbose=False, device="cpu").run(
                [slide], patch_mode=False, ioconfig=io, save_dir=f"{tmp}/{extractor.backbone}", output_type="zarr")
            group = open_zarr(written[str(slide)])
            assert group["features"].shape == (len(group["coordinates"][:]), extractor.num_features)
        from tiatoolbox_tpu_torch.models.architecture.vit import VisionTransformer

        narrow = VisionTransformer(patch_size=8, embed_dim=32, depth=1, num_heads=2, reg_tokens=2, swiglu=True,
                                   init_values=1e-5, img_size=64)
        assert narrow(torch.zeros(1, 64, 64, 3)).shape == (1, 32)

        # the registry's tail: KongNet (V2-S) on the detector, GrandQC's JPEG
        # round trip and EfficientUNet's ellipse morphology on the semantic
        # engine, NuClick's clicks
        from tiatoolbox_tpu_torch.models.architecture.efficientunet_tissue_mask_model import (
            EfficientUNetTissueMaskModel,
        )
        from tiatoolbox_tpu_torch.models.architecture.grandqc import GrandQCModel
        from tiatoolbox_tpu_torch.models.architecture.kongnet import KongNet
        from tiatoolbox_tpu_torch.models.architecture.nuclick import NuClick

        kong = KongNet(2, [3, 3], [2, 5], 3, 0.0, variant="efficientnetv2_s", device="cpu")
        found = NucleusDetector(kong, batch_size=4, verbose=False, device="cpu").run(
            [small], patch_mode=False, auto_get_mask=False, ioconfig=IOSegmentorConfig(
                input_resolutions=[{"units": "mpp", "resolution": 0.5}],
                output_resolutions=[{"units": "mpp", "resolution": 0.5}],
                patch_input_shape=(64, 64), stride_shape=(56, 56)))[str(small)]
        assert set(np.unique(found["types"])) <= {0, 1}
        for tissue in (GrandQCModel(device="cpu"), EfficientUNetTissueMaskModel(device="cpu")):
            tio = IOSegmentorConfig(input_resolutions=[{"units": "mpp", "resolution": 2.0}],
                                    output_resolutions=[{"units": "mpp", "resolution": 2.0}],
                                    patch_input_shape=(64, 64), stride_shape=(48, 48))
            probs = SemanticSegmentor(tissue, batch_size=4, verbose=False, device="cpu").run(
                [slide], patch_mode=False, ioconfig=tio, auto_get_mask=False)[str(slide)]["probabilities"]
            assert tissue.postproc(probs).shape == probs.shape[:2]
        clicks = np.zeros((1, 64, 64, 5), np.float32)
        clicks[0, 30, 30, 3] = 1
        nuclick = NuClick(device="cpu")
        masks = NuClick.infer_batch(nuclick, clicks)
        assert NuClick.postproc(masks, nuc_points=clicks[..., 3], do_reconstruction=True).shape == (1, 64, 64)

        # the stain API: Reinhard, Vahadane (the numpy dictionary learning),
        # stain augmentation (K7's plain version on the CPU)
        from tiatoolbox_tpu_torch.tools.stainaugment import StainAugmentor, augment_tiles

        patch = synthetic_he_patch((96, 96), seed=4)
        for name in ("reinhard", "vahadane"):
            stain_norm = get_normalizer(name)
            stain_norm.fit(patch)
            assert np.asarray(stain_norm.transform_tiles(tiles[:1], device="cpu")).shape == (1, 64, 64, 3)
        augmented = augment_tiles(tiles, stain_norm.stain_matrix_target, torch.Generator().manual_seed(0),
                                  device="cpu")
        assert augmented.shape == tiles.shape
        assert StainAugmentor("macenko", always_apply=True)(patch)["image"].shape == patch.shape

        # the readers on the port's own codecs
        from tiatoolbox_tpu_torch import native
        from tiatoolbox_tpu_torch.data.synth import make_synthetic_dicom, write_synthetic_mrxs
        from tiatoolbox_tpu_torch.utils.tiff_to_fsspec import tiff_to_fsspec
        from tiatoolbox_tpu_torch.utils.zarrlite import ZarrGroup
        from tiatoolbox_tpu_torch.wsicore.store_reader import FsspecJsonWSIReader

        image = reader.read_rect((0, 0), (256, 256))
        mrxs = write_synthetic_mrxs(f"{tmp}/m", grid_nx=4, grid_ny=4, tile=64, n_levels=1, level_images=[image])
        dcm = make_synthetic_dicom(f"{tmp}/d.dcm", image=image, frame_size=64, compression="jpeg")
        group = ZarrGroup.create(f"{tmp}/n.zarr")
        group.from_array("0", image)
        group.attrs = {"multiscales": [{"version": "0.4", "datasets": [{"path": "0"}]}]}
        deflate = make_synthetic_slide(f"{tmp}/deflate.tiff", size=(256, 256), compression="deflate")
        tiff_to_fsspec(deflate, str(deflate), f"{tmp}/refs.json")
        import struct, zlib

        def chunk(kind, body):
            return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

        rows = b"".join(b"\\x00" + image[y].tobytes() for y in range(256))
        with open(f"{tmp}/flat.png", "wb") as fh:
            fh.write(b"\\x89PNG\\r\\n\\x1a\\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 256, 256, 8, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))
        assert np.array_equal(WSIReader.open(f"{tmp}/flat.png").read_rect((0, 0), (256, 256)), image)
        assert native.decode_jpeg(native.encode_jpeg(image, 95)).shape == image.shape
        for path in (mrxs, dcm, f"{tmp}/n.zarr"):
            assert WSIReader.open(path).read_rect((0, 0), (256, 256)).shape == (256, 256, 3)
        assert FsspecJsonWSIReader(f"{tmp}/refs.json").read_rect((0, 0), (256, 256)).shape == (256, 256, 3)
        from tiatoolbox_tpu_torch.wsicore.jp2 import encode_tiled_j2k, jp2_container

        with open(f"{tmp}/slide.jp2", "wb") as fh:
            fh.write(jp2_container(encode_tiled_j2k(image, 128), mpp=(0.5, 0.5)))
        jp2 = WSIReader.open(f"{tmp}/slide.jp2")
        assert np.array_equal(jp2.read_rect((0, 0), (256, 256)), image)
        assert jp2.read_rect((0, 0), (64, 64), resolution=1.0, units="mpp").shape == (64, 64, 3)

        # SAM from a checkpoint directory written with numpy (the port's own
        # safetensors reader), PromptSegmentor with a point and a box
        from tiatoolbox_tpu_torch.models.architecture.sam import SAM, save_sam_checkpoint, seeded_sam_state
        from tiatoolbox_tpu_torch.models.architecture.sam_config import (
            PreprocessorConfig, SamConfig, SamMaskDecoderConfig, SamPromptEncoderConfig, SamVisionConfig)
        from tiatoolbox_tpu_torch.models.engine import PromptSegmentor

        tiny = SamConfig(SamVisionConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                         global_attn_indexes=(1,), window_size=4, image_size=96,
                                         output_channels=16, num_pos_feats=8),
                         SamPromptEncoderConfig(hidden_size=16, image_size=96),
                         SamMaskDecoderConfig(hidden_size=16, mlp_dim=32, num_attention_heads=2,
                                              iou_head_hidden_dim=16))
        sam_dir = save_sam_checkpoint(f"{tmp}/sam", seeded_sam_state(tiny, seed=1), tiny,
                                      PreprocessorConfig(longest_edge=96, pad_height=96, pad_width=96))
        stores = PromptSegmentor(model=SAM(sam_dir, device="cpu")).run(
            [image[:120, :80]], point_coords=np.array([[[40, 50]]]), box_coords=np.array([[[10, 10, 70, 100]]]),
            save_dir=f"{tmp}/prompt", device="cpu")
        assert len(stores) == 1 and SQLiteStore(stores[0]) is not None

        # registration: prealignment, DFBR and a few B-spline steps, then a
        # read through the transform
        from tiatoolbox_tpu_torch.tools.registration import (
            DFBRegister, estimate_bspline_transform, prealignment)
        from tiatoolbox_tpu_torch.utils.warp import warp_affine
        from tiatoolbox_tpu_torch.wsicore.store_reader import TransformedWSIReader

        fixed = np.full((128, 128, 3), 255, np.uint8)
        fixed[24:104, 16:88] = image[24:104, 16:88]
        rotation = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 128.0]])
        moving = warp_affine(fixed, rotation, (128, 128), border_value=255)
        masks = [(img.min(axis=-1) < 250).astype(np.uint8) for img in (fixed, moving)]
        pre, *_ = prealignment(fixed, moving, *masks)
        affine = DFBRegister(patch_size=(64, 64), device="cpu").register(fixed, moving, transform_initializer=pre)
        field = estimate_bspline_transform(fixed, moving, n_iterations=3, grid_space=32, device="cpu")
        assert field.shape == (128, 128, 2) and np.isfinite(affine).all()
        assert TransformedWSIReader(moving, affine).read_rect((0, 0), (64, 64)).shape == (64, 64, 3)

        # rendering and tiles (the rasteriser's C++), the slide graph, UMAP, Kather info
        from tiatoolbox_tpu_torch.annotation.geometry import Point, Polygon
        from tiatoolbox_tpu_torch.annotation.storage import Annotation, SQLiteStore
        from tiatoolbox_tpu_torch.data.render_golden import check_graph_golden, check_raster_golden
        from tiatoolbox_tpu_torch.models.dataset.info import KatherPatchDataset
        from tiatoolbox_tpu_torch.tools.graph import SlideGraphConstructor
        from tiatoolbox_tpu_torch.tools.pyramid import AnnotationTileGenerator, ZoomifyGenerator
        from tiatoolbox_tpu_torch.utils.misc import imwrite
        from tiatoolbox_tpu_torch.utils.visualization import overlay_probability_map, plot_graph

        store = SQLiteStore(f"{tmp}/render.db")
        store.append(Annotation(Polygon([(10, 10), (300, 40), (200, 300)]), {"type": 1}))
        store.append(Annotation(Point(400, 200), {"type": 2}))
        store.commit()
        store.close()
        over = WSIReader.open(f"{tmp}/render.db", base_wsi=slide, alpha=0.5)
        assert type(over).__name__ == "AnnotationStoreReader"
        assert over.read_rect((0, 0), (128, 128)).shape == (128, 128, 3)
        AnnotationTileGenerator(reader.info, over.store).dump(f"{tmp}/tiles.zip", container="zip")
        ZoomifyGenerator(reader, tile_size=128).dump(f"{tmp}/zoomify.tar", container="tar")
        heat = overlay_probability_map(reader.slide_thumbnail(resolution=5, units="power"),
                                       np.full(reader.slide_thumbnail(resolution=5, units="power").shape[:2], 0.5))
        imwrite(f"{tmp}/heat.png", heat)
        imwrite(f"{tmp}/heat.jpg", heat)
        assert check_raster_golden() > 0 and check_graph_golden()["edges"] > 0
        rng = np.random.default_rng(0)
        graph = SlideGraphConstructor.build(rng.uniform(0, 4000, (40, 2)), rng.random((40, 8)))
        colours = SlideGraphConstructor._umap_reducer(graph)
        plot_graph(np.zeros((64, 64, 3), np.uint8), graph["coordinates"] / 64, graph["edge_index"].T,
                   node_colors=[tuple(int(v) for v in c) for c in colours * 255])
        assert KatherPatchDataset(f"{tmp}/no_kather")[0]["image"].shape == (224, 224, 3)

        # the CLI on argparse and the tile server on wsgiref, with the YAML
        # writer and reader of the port's own
        import contextlib, io, urllib.request
        from pathlib import Path
        from tiatoolbox_tpu_torch.cli import main
        from tiatoolbox_tpu_torch.utils import yaml_lite
        from tiatoolbox_tpu_torch.visualization.tileserver import TileServer

        slide_path = str(reader.input_path)
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["version"]) == 0
            assert main(["slide-info", "--img-input", slide_path, "--mode", "save",
                         "--output-path", f"{tmp}/info"]) == 0
            assert main(["save-tiles", "--img-input", slide_path, "--output-path", f"{tmp}/saved",
                         "--tile-objective-value", "10"]) == 0
        info = yaml_lite.load(next(Path(f"{tmp}/info").glob("*.yaml")).read_text())
        assert int(info["level_count"]) >= 1
        server = TileServer(layers={"slide": slide_path, "anns": f"{tmp}/render.db"})
        httpd, port = server.run_in_thread()
        url = f"http://127.0.0.1:{port}/tileserver"
        with urllib.request.urlopen(f"{url}/layer/slide/default/zoomify/TileGroup0/0-0-0.jpg") as resp:
            assert resp.read()[:2] == bytes((0xFF, 0xD8))
        with urllib.request.urlopen(f"{url}/layer/anns/default/zoomify/TileGroup0/0-0-0.jpg") as resp:
            assert resp.read()[:4] == bytes((0x89,)) + b"PNG"
        urllib.request.urlopen(urllib.request.Request(f"{url}/shutdown", data=b"", method="PUT")).read()

    leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("GUARDED_OK", len(names))
    """
)


def test_port_imports_and_runs_without_jax_cv2_or_yaml() -> None:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", GUARDED_RUN],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
        check=False,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "GUARDED_OK" in proc.stdout


def test_no_top_level_import_of_refused_packages() -> None:
    import re

    pattern = re.compile(
        r"^\s*(import|from) (jax|flax|cv2|yaml|PIL|psutil|sklearn|fsspec|matplotlib|transformers|safetensors|"
        r"huggingface_hub|click|joblib|tiatoolbox_tpu)\b",
        re.M,
    )
    sources = [REPO / "chip_smoke.py", *sorted((REPO / "tiatoolbox_tpu_torch").rglob("*.py"))]
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders
