"""Where the tile server's ``segment_on_box`` spends its time, on the card.

    python3 scripts/profile_segment_on_box.py

Runs the 1024^2 region that ``chip_smoke.py``'s ``serve`` phase segments
(the centre of a 4096x3072 synthetic slide at 0.25 mpp) through
``MultiTaskSegmentor`` with the functional ``hovernet_fast-pannuke``
checkpoint, as the server does (``visualization/tileserver.py::
region_ioconfig``), at the server's batch 4 and at phase D's batch 32 (two
warm runs each, then batch 4 again), with TF32 off as in the smoke. Then
the forward alone at batch 4 and 32 (CUDA events, ``chip_smoke.time_ms``),
and a ``torch.profiler`` table of one batch-4 run. Prints one JSON line a
run, the profiler's tables, and last the card's name and power limit.
Needs the card.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tiatoolbox_tpu_torch import rcParam  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture import get_pretrained_model  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.hovernet_checkpoint import functional_hovernet_state_dict  # noqa: E402
from tiatoolbox_tpu_torch.models.engine import MultiTaskSegmentor  # noqa: E402
from tiatoolbox_tpu_torch.visualization.tileserver import region_ioconfig  # noqa: E402
from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader  # noqa: E402

BOX = (1536, 1024, 2560, 2048)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs the card", file=sys.stderr)
        return 1
    card = cs.card_name_and_limit()
    cs._build.build_all()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"cudnn_benchmark": torch.backends.cudnn.benchmark}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "models").mkdir()
        torch.save(functional_hovernet_state_dict(), tmp / "models" / "hovernet_fast-pannuke.pth")
        rcParam["TIATOOLBOX_HOME"] = tmp
        slide = cs.make_synthetic_slide(tmp / "d.tiff", size=(4096, 3072), mpp=0.25, objective_power=40,
                                        compression="deflate")
        region = WSIReader.open(slide).read_bounds(BOX, resolution=0.25, units="mpp")
        model, ioconfig = get_pretrained_model("hovernet_fast-pannuke")
        cfg = region_ioconfig(ioconfig)
        for batch in (4, 4, 32, 32, 4):
            engine = MultiTaskSegmentor(model, batch_size=batch, num_loader_workers=0, verbose=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = next(iter(engine.run([region], patch_mode=False, ioconfig=cfg, auto_get_mask=False).values()))
            torch.cuda.synchronize()
            stages = {k: v for k, v in engine.last_stage_summary.items() if isinstance(v, dict)}
            print(json.dumps({"batch": batch, "seconds": time.perf_counter() - t0,
                              "instances": len(out["instances"]), "stages": stages}), flush=True)
        for batch in (4, 32):
            x = torch.randint(0, 255, (batch, 256, 256, 3), dtype=torch.uint8, device="cuda")
            ms = cs.time_ms(lambda x=x: model.infer_batch_device(model, x), 10)
            print(json.dumps({"forward_batch": batch, "ms": ms, "ms_per_patch": ms / batch}), flush=True)
        engine = MultiTaskSegmentor(model, batch_size=4, num_loader_workers=0, verbose=False)
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            engine.run([region], patch_mode=False, ioconfig=cfg, auto_get_mask=False)
        print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=25), flush=True)
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
