"""A JAX caller's run parameters on the port's engines.

JAX's ``EngineABC.run`` takes ``transfer_threads`` (the threads that stage
batches over its relay link) and ``MultiTaskSegmentor.run`` takes
``drain_during_loop`` (drain finished canvas rows while the loop runs).
The port accepts both and neither changes what it does: it copies on one
CUDA copy stream, and its drain always runs. A ``PatchPredictor`` run with
``transfer_threads=2`` and a ``MultiTaskSegmentor`` run with
``drain_during_loop=True`` (and ``False``) give the outputs of the same
runs without the keys, on the CPU; JAX's engines take the same keys.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_multitask_views import IOCONFIG, _rows
from test_torch_parallel import _ClosedFormHoVerNet
from tiatoolbox_tpu.models.engine.multi_task_segmentor import MultiTaskSegmentor as JaxMultiTaskSegmentor
from tiatoolbox_tpu.models.engine.patch_predictor import PatchPredictor as JaxPatchPredictor
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide
from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNModel
from tiatoolbox_tpu_torch.models.engine import IOInstanceSegmentorConfig, IOPatchPredictorConfig, MultiTaskSegmentor
from tiatoolbox_tpu_torch.models.engine.patch_predictor import PatchPredictor

PREDICT_IOCONFIG = dict(input_resolutions=[{"units": "mpp", "resolution": 2.0}], patch_input_shape=(32, 32))


@pytest.fixture(scope="module")
def slides(tmp_path_factory) -> dict[str, str]:
    root = tmp_path_factory.mktemp("run_params")
    predict = make_synthetic_slide(root / "predict.tiff", size=(512, 384), mpp=0.5, seed=5, compression="deflate")
    instance = make_synthetic_slide(root / "instance.tiff", size=(600, 440), mpp=0.25, objective_power=40,
                                    compression="deflate")
    return {"predict": str(predict), "instance": str(instance)}


def test_jax_engines_take_the_keys() -> None:
    assert "transfer_threads" in JaxPatchPredictor._RUN_PARAMS  # noqa: SLF001
    assert "drain_during_loop" in JaxMultiTaskSegmentor._RUN_PARAMS  # noqa: SLF001


def test_patch_predictor_run_with_transfer_threads(slides) -> None:
    model = CNNModel("resnet18", num_classes=4, device="cpu")
    with torch.no_grad():
        model.classifier.weight.mul_(0.02)
    slide = slides["predict"]

    def run(**keys) -> dict:
        predictor = PatchPredictor(model, batch_size=8, num_loader_workers=0, device="cpu", verbose=False)
        return predictor.run([slide], patch_mode=False, ioconfig=IOPatchPredictorConfig(**PREDICT_IOCONFIG),
                             auto_get_mask=False, **keys)[slide]

    plain, keyed = run(), run(transfer_threads=2)
    assert keyed.keys() == plain.keys()
    for key in plain:
        np.testing.assert_array_equal(np.asarray(keyed[key]), np.asarray(plain[key]), err_msg=key)


@pytest.mark.parametrize("drain", [True, False])
def test_multitask_run_with_drain_during_loop(slides, drain: bool) -> None:
    slide = slides["instance"]

    def run(**keys) -> list:
        seg = MultiTaskSegmentor(_ClosedFormHoVerNet(), batch_size=8, num_loader_workers=0, device="cpu",
                                 verbose=False)
        out = seg.run([slide], patch_mode=False, ioconfig=IOInstanceSegmentorConfig(**IOCONFIG),
                      auto_get_mask=False, **keys)[slide]
        return _rows(out["instances"])

    plain = run()
    assert len(plain) > 5
    assert run(drain_during_loop=drain) == plain
