"""Batch data parallelism (``parallel/mesh.py``, ``ModelABC.enable_data_parallel``) on the CPU.

``mesh.local_devices`` is replaced by four CPU devices, as JAX's tests run
on 8 virtual CPU devices (``tests/conftest.py``); the JAX package's
``enable_data_parallel`` runs on those 8. The port's mesh of four replicas
is held against the single-device port and against JAX's dp runs:

- resnet18 forward, an uneven batch of 13 included, within 1e-5;
- ``PatchPredictor`` over a slide, within 1e-5 of the single-device port
  and 1e-3 of JAX's dp run (the classifier's tolerance);
- ``SemanticSegmentor`` within 1e-4 of both (the narrow U-Net);
- ``MultiTaskSegmentor``: the same instances as the single-device run on
  JAX's 600x440 slide, box, centroid, contour and type. HoVer-Net's
  forward is replaced here by maps in closed form (a darkness detector, as
  its functional checkpoint): the full-width network takes seconds a patch
  on a CPU, and ``chip_smoke.py``'s dp phase runs it on the card;
- dp on the yuv420 wire, as JAX's ``test_dp_yuv_wire``;
- ``state_dict()`` keys unchanged by ``enable_data_parallel``, and weights
  loaded after it reach every replica;
- JAX's single-process ``TestMultiHost`` cases.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_colorconv import PREDICT_IOCONFIG, resnet_pair
from test_torch_segmentor import KWARGS as UNET_KWARGS
from test_torch_segmentor import _ioconfigs
from test_torch_unet import calibrated_state, flax_variables
from tiatoolbox_tpu.models.architecture.unet import UNetModel as JaxUNetModel
from tiatoolbox_tpu.models.engine.io_config import IOPatchPredictorConfig as JaxIOConfig
from tiatoolbox_tpu.models.engine.patch_predictor import PatchPredictor as JaxPatchPredictor
from tiatoolbox_tpu.models.engine.semantic_segmentor import SemanticSegmentor as JaxSegmentor
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide
from tiatoolbox_tpu_torch.models.architecture.hovernet import HoVerNet
from tiatoolbox_tpu_torch.models.architecture.unet import UNetModel
from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNModel
from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_unet_to_torch
from tiatoolbox_tpu_torch.models.engine import IOInstanceSegmentorConfig, MultiTaskSegmentor, SemanticSegmentor
from tiatoolbox_tpu_torch.models.engine.io_config import IOPatchPredictorConfig
from tiatoolbox_tpu_torch.models.engine.patch_predictor import PatchPredictor
from tiatoolbox_tpu_torch.parallel import (
    BatchLoader,
    get_data_mesh,
    get_hybrid_data_mesh,
    initialize_multihost,
    mesh,
    pad_to_multiple,
    shard_batch,
    shard_batch_multihost,
)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def four_devices(monkeypatch):
    """Four CPU devices in place of the card's list; two intra-op threads."""
    monkeypatch.setattr(mesh, "local_devices", lambda: [CPU] * 4)
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def slide(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("dp") / "slide.tiff"
    make_synthetic_slide(path, size=(512, 384), mpp=0.5, seed=5, compression="deflate")
    return str(path)


@pytest.fixture(scope="module")
def jax_dp():
    """JAX's resnet18 of ``resnet_pair`` under its dp mesh of 8 devices,
    shared so that each batch shape compiles once."""
    model = resnet_pair()[0]
    model.enable_data_parallel()
    return model


# -- the mesh --------------------------------------------------------------------------


def test_mesh_over_the_local_devices() -> None:
    m = get_data_mesh()
    assert m.size == 4 and m.axis_names == ("data",) and m.devices == (CPU,) * 4
    assert get_data_mesh(2).size == 2


def test_no_card_no_mesh(monkeypatch) -> None:
    monkeypatch.undo()  # the real local_devices
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_data_mesh()


def test_pad_to_multiple_as_jax() -> None:
    from tiatoolbox_tpu.parallel import pad_to_multiple as jax_pad

    batch = np.arange(10)[:, None]
    padded, n_valid = pad_to_multiple(batch, 8)
    want, want_n = jax_pad(batch, 8)
    assert n_valid == want_n == 10
    np.testing.assert_array_equal(padded, want)
    assert pad_to_multiple(np.zeros((8, 2)), 8)[0].shape[0] == 8


@pytest.mark.parametrize("n_devices", [None, 2])
def test_shard_batch_layout(n_devices) -> None:
    m = get_data_mesh(n_devices)
    batch = np.random.default_rng(0).random((16, 4)).astype(np.float32)
    chunks = shard_batch(batch, m)
    assert [tuple(c.shape) for c in chunks] == [(16 // m.size, 4)] * m.size
    np.testing.assert_array_equal(torch.cat(chunks).numpy(), batch)
    with pytest.raises(ValueError, match="pad it first"):
        shard_batch(batch[:9], m)


# -- the forward -----------------------------------------------------------------------


@pytest.mark.parametrize("n", [16, 13])
def test_dp_forward_matches_single_device_and_jax(jax_dp, n: int) -> None:
    _, port = resnet_pair()
    batch = np.random.default_rng(0).integers(0, 255, (n, 32, 32, 3), np.uint8)
    single = CNNModel.infer_batch(port, batch)
    keys = list(port.state_dict())
    port.enable_data_parallel()
    assert port.mesh.size == 4 and port.device == CPU
    assert list(port.state_dict()) == keys  # the replicas are outside the registry
    dp = CNNModel.infer_batch(port, batch)
    assert dp.shape == single.shape == (n, 4)
    np.testing.assert_allclose(dp, single, atol=1e-5, rtol=0)
    want = np.asarray(jax_dp.infer_batch(jax_dp, batch))[:n]
    np.testing.assert_allclose(dp, want, atol=1e-5, rtol=0)


def test_weights_loaded_after_enable_reach_every_replica() -> None:
    _, port = resnet_pair()
    other = CNNModel("resnet18", num_classes=4, seed=3, device="cpu")
    batch = np.random.default_rng(1).integers(0, 255, (8, 32, 32, 3), np.uint8)
    port.enable_data_parallel()
    CNNModel.infer_batch(port, batch)  # replicas in use before the load
    port.load_state_dict(other.state_dict())
    np.testing.assert_allclose(CNNModel.infer_batch(port, batch), CNNModel.infer_batch(other, batch), atol=1e-5, rtol=0)
    for replica in port._replicas:
        for a, b in zip(replica.state_dict().values(), other.state_dict().values()):
            assert torch.equal(a, b)
    port.mesh = None
    assert port._replicas == []


def test_dp_on_the_yuv_wire(jax_dp) -> None:
    """As JAX's ``test_dp_yuv_wire``: the staged batch is planes, the dp
    result on them is the single-device one, and close to the RGB wire's."""
    _, port = resnet_pair()
    batch = np.random.default_rng(2).integers(0, 255, (16, 32, 32, 3), np.uint8)
    rgb = CNNModel.infer_batch(port, batch)
    port.wire_format = "yuv420"
    staged = port.stage_batch(batch)
    assert staged.ndim == 3  # packed planes
    single = CNNModel.infer_batch(port, staged)
    port.enable_data_parallel()
    dp = CNNModel.infer_batch(port, staged)
    np.testing.assert_allclose(dp, single, atol=1e-5, rtol=0)
    assert np.abs(dp - rgb).max() < 0.15
    jax_dp.wire_format = "yuv420"
    try:
        want = np.asarray(jax_dp.infer_batch(jax_dp, jax_dp.stage_batch(batch)))[:16]
    finally:
        jax_dp.wire_format = "rgb"
    np.testing.assert_allclose(dp, want, atol=1e-5, rtol=0)


# -- the engines ---------------------------------------------------------------------


def test_dp_patch_predictor(jax_dp, slide: str) -> None:
    _, port = resnet_pair()
    run = dict(patch_mode=False, auto_get_mask=False)
    single = PatchPredictor(port, batch_size=16, num_loader_workers=0, device="cpu", verbose=False).run(
        [slide], ioconfig=IOPatchPredictorConfig(**PREDICT_IOCONFIG), **run
    )[slide]
    port.enable_data_parallel()
    dp = PatchPredictor(port, batch_size=16, num_loader_workers=0, device="cpu", verbose=False).run(
        [slide], ioconfig=IOPatchPredictorConfig(**PREDICT_IOCONFIG), **run
    )[slide]
    assert dp["probabilities"].shape == (12, 4)  # 512x384 at 2 mpp: a 4x3 grid of 32^2
    np.testing.assert_allclose(dp["probabilities"], single["probabilities"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(dp["coordinates"], single["coordinates"])
    want = JaxPatchPredictor(jax_dp, batch_size=16, num_loader_workers=0, verbose=False).run(
        [slide], ioconfig=JaxIOConfig(**PREDICT_IOCONFIG), **run
    )[slide]
    np.testing.assert_allclose(dp["probabilities"], np.asarray(want["probabilities"]), atol=1e-3, rtol=0)


def test_dp_semantic_segmentor(slide: str) -> None:
    variables = flax_variables(calibrated_state(UNET_KWARGS, seed=22))
    jax_model = JaxUNetModel(**UNET_KWARGS)
    jax_model.load_weights(variables)
    port = UNetModel(**UNET_KWARGS, device="cpu")
    port.load_state_dict(flax_unet_to_torch(variables))
    ioconfig = _ioconfigs(0.5, 64, 48)
    run = dict(patch_mode=False, auto_get_mask=False)

    def port_run():
        seg = SemanticSegmentor(port, batch_size=8, num_loader_workers=0, device="cpu", verbose=False)
        return seg.run([slide], ioconfig=ioconfig[1], **run)[slide]["probabilities"], seg.last_stage_summary

    single, _ = port_run()
    port.enable_data_parallel()
    dp, summary = port_run()
    assert summary["path"] == "device-canvas+region-feed"  # the canvas stays on the first device
    np.testing.assert_allclose(dp, single, atol=1e-4, rtol=0)
    jax_model.enable_data_parallel()
    want = JaxSegmentor(jax_model, batch_size=8, num_loader_workers=0, verbose=False).run(
        [slide], ioconfig=ioconfig[0], **run
    )[slide]
    np.testing.assert_allclose(dp, np.asarray(want["probabilities"]), atol=1e-4, rtol=0)


class _ClosedFormHoVerNet(HoVerNet):
    """HoVer-Net's heads, engine hooks and post-processing over maps in closed
    form: ``d = relu(0.70 - mean7x7(grey))`` cut to the 164^2 output, np and
    tp logits of ``80 (d - 0.03)``, hv a Sobel of ``d``. Only the stem is
    kept of the network (the replicas' parameters)."""

    def __init__(self) -> None:
        super().__init__(num_types=6, mode="fast", device="cpu")
        for name in ("d0", "d1", "d2", "d3", "conv_bot", "decoder"):
            delattr(self, name)

    def forward(self, batch: torch.Tensor) -> dict[str, torch.Tensor]:
        grey = batch.permute(0, 3, 1, 2).float().mean(1, keepdim=True) / 255.0
        d = F.relu(0.70 - F.avg_pool2d(grey, 7, stride=1, padding=3))[..., 46:210, 46:210]
        fg = 80.0 * (d - 0.03)
        sobel = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])
        hv = torch.cat([F.conv2d(d, k[None, None], padding=1) for k in (sobel, sobel.T)], dim=1)
        tp = torch.cat([-fg, fg, *[torch.zeros_like(fg)] * 4], dim=1)
        nhwc = lambda x: x.permute(0, 2, 3, 1)  # noqa: E731
        return {"np": nhwc(torch.cat([-fg / 2, fg / 2], dim=1)), "hv": nhwc(-hv), "tp": nhwc(tp)}


def test_dp_multitask_segmentor_keeps_the_instances(tmp_path) -> None:
    path = make_synthetic_slide(tmp_path / "s.tiff", size=(600, 440), mpp=0.25, objective_power=40)
    ioconfig = IOInstanceSegmentorConfig(
        input_resolutions=[{"units": "mpp", "resolution": 0.25}],
        output_resolutions=[{"units": "mpp", "resolution": 0.25}],
        patch_input_shape=(256, 256),
        patch_output_shape=(164, 164),
        stride_shape=(164, 164),
        margin=64,
        tile_shape=(2048, 2048),
        save_resolution={"units": "mpp", "resolution": 0.25},
    )
    model = _ClosedFormHoVerNet()

    def instances():
        seg = MultiTaskSegmentor(model, batch_size=8, num_loader_workers=0, device="cpu", verbose=False)
        out = seg.run([str(path)], patch_mode=False, ioconfig=ioconfig, auto_get_mask=False)[str(path)]
        return sorted(
            (np.asarray(v["box"]).tolist(), np.round(np.asarray(v["centroid"], float), 2).tolist(),
             np.asarray(v["contours"]).tolist(), int(v["type"]))
            for v in out["instances"].values()
        )

    base = instances()
    assert len(base) > 5
    model.enable_data_parallel()
    assert instances() == base


# -- multi-process plumbing, single process ------------------------------------------------


def test_initialize_is_a_noop_in_one_process(monkeypatch) -> None:
    for key in ("WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    assert initialize_multihost() is False
    assert not torch.distributed.is_initialized()


def test_hybrid_mesh_is_the_local_mesh() -> None:
    hybrid = get_hybrid_data_mesh()
    assert hybrid == get_data_mesh()
    assert hybrid.axis_names == ("data",) and (hybrid.process_index, hybrid.process_count) == (0, 1)


def test_shard_batch_multihost_in_one_process() -> None:
    batch = np.random.default_rng(3).random((16, 4)).astype(np.float32)
    chunks = shard_batch_multihost(batch)
    assert [tuple(c.shape) for c in chunks] == [(4, 4)] * 4
    np.testing.assert_array_equal(torch.cat(chunks).numpy(), batch)


def test_exports_match_jax() -> None:
    import tiatoolbox_tpu.parallel as jax_parallel
    import tiatoolbox_tpu_torch.parallel as port_parallel

    names = {n for n in dir(jax_parallel) if not n.startswith("_") and n not in ("mesh", "pipeline")}
    assert names <= set(dir(port_parallel))
    assert BatchLoader is port_parallel.BatchLoader
