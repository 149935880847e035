"""The port's tile server and CLI on the card.

The card machine has neither JAX's flax nor cv2, so this file imports the
port only; ``tests/test_torch_tileserver.py`` and ``tests/test_torch_cli.py``
hold the CPU runs against JAX. The server runs on a thread on
``rcParam["device"]``'s default (the card) and answers a slide tile and a
``segment_on_box`` over HTTP; the box's layer equals a direct
``MultiTaskSegmentor.run`` of the same region on the card (instance count,
types and contours), and the run launched the canvas (K2), energy (K5) and
packing (K6) kernels. Run them there with
``python -m pytest -m cuda tests/test_torch_server_card.py``.
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from tiatoolbox_tpu_torch import rcParam
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide
from tiatoolbox_tpu_torch.models.architecture.hovernet_checkpoint import functional_hovernet_state_dict
from tiatoolbox_tpu_torch.ops.canvas import pack_fg_tp, scatter_accumulate
from tiatoolbox_tpu_torch.ops.hv_energy import hv_energy
from tiatoolbox_tpu_torch.visualization.tileserver import TileServer, region_ioconfig

pytestmark = pytest.mark.cuda

BOX = {"x0": 100, "y0": 80, "x1": 500, "y1": 420}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs the card; chip_smoke.py's serve phase runs these checks there at full size")
    tmp = tmp_path_factory.mktemp("card_server")
    (tmp / "home" / "models").mkdir(parents=True)
    torch.save(functional_hovernet_state_dict(), tmp / "home" / "models" / "hovernet_fast-pannuke.pth")
    old = rcParam["TIATOOLBOX_HOME"]
    rcParam["TIATOOLBOX_HOME"] = tmp / "home"
    slide = tmp / "slide.tiff"
    make_synthetic_slide(slide, size=(760, 560), mpp=0.25, objective_power=40, compression="deflate")
    server = TileServer(layers={"slide": str(slide)})
    httpd, port = server.run_in_thread()
    yield server, f"http://127.0.0.1:{port}/tileserver"
    httpd.shutdown()
    httpd.server_close()
    rcParam["TIATOOLBOX_HOME"] = old


def test_slide_tile_on_the_card_server(served) -> None:
    _server, url = served
    with urllib.request.urlopen(f"{url}/layer/slide/default/zoomify/TileGroup0/2-1-1.jpg", timeout=60) as resp:
        assert resp.headers["Content-Type"] == "image/jpeg"
        assert resp.read()[:2] == bytes((0xFF, 0xD8))


def test_segment_on_box_on_the_card(served) -> None:
    from tiatoolbox_tpu_torch.models.architecture import get_pretrained_model
    from tiatoolbox_tpu_torch.models.engine.multi_task_segmentor import MultiTaskSegmentor

    server, url = served
    before = (scatter_accumulate.launches, hv_energy.launches, pack_fg_tp.launches)
    req = urllib.request.Request(f"{url}/segment_on_box", data=urllib.parse.urlencode(BOX).encode(), method="PUT")
    with urllib.request.urlopen(req, timeout=600) as resp:
        result = json.loads(resp.read())
    after = (scatter_accumulate.launches, hv_energy.launches, pack_fg_tp.launches)
    assert result["layer"] == "segment" and result["count"] > 5
    assert all(a > b for a, b in zip(after, before, strict=True)), (before, after)
    # the same region through the engine, called directly on the card
    reader = server.layers["slide"]
    region = reader.read_bounds(tuple(BOX.values()), resolution=0.25, units="mpp")
    model, ioconfig = get_pretrained_model("hovernet_fast-pannuke")
    engine = MultiTaskSegmentor(model, batch_size=4, num_loader_workers=0, verbose=False)
    direct = next(iter(engine.run([region], patch_mode=False, ioconfig=region_ioconfig(ioconfig),
                                  auto_get_mask=False).values()))["instances"]
    store = server.layers["segment"]

    def order(row):
        return (row[0], *row[1].min(axis=0), *row[1].max(axis=0), len(row[1]))

    want = sorted(((int(i["type"]), np.asarray(i["contours"], float) + [BOX["x0"], BOX["y0"]])
                   for i in direct.values() if len(i["contours"]) >= 3), key=order)
    got = sorted(((a.properties["type"], np.asarray(a.geometry.shell, float)[:-1]) for a in store.values()), key=order)
    assert len(got) == len(want) == result["count"]
    for (gt, gc), (wt, wc) in zip(got, want, strict=True):
        assert gt == wt
        np.testing.assert_array_equal(gc, wc)
