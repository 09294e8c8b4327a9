"""The north star's bf16 bar on trained weights: run the accuracy gate
(:mod:`hmvit_tpu_torch.prod_overfit`, the same flags), then load its
trained weights into the bf16 split server (every layer in bfloat16, the
serving hints of each frame's fleet) and the fp32 forward, and compare
them on the gate's fixture frames: max |sigmoid(psm) difference| against
1.8e-4, beside the logits, the anchors over the score threshold and rm.

    python -m hmvit_tpu_torch.tools.bf16_bar [prod_overfit flags]

One JSON line a frame, then the worst; on the card unless ``--cpu``.
"""
from __future__ import annotations

import json
import sys

import torch

from .. import prod_overfit
from ..models.hmvit import HMViT
from ..serving import GEOMETRY_KEYS, serving_config, serving_hints
from ..utils.precision import strict_fp32

BAR = 1.8e-4
SCORE_THRESHOLD = 0.27


def bar_readings(state_dict: dict, cfg: dict, batches, dev) -> list:
    """One reading a frame of the bf16 split server against the fp32
    forward of the same weights (``batches``: float32 device batches of
    one frame each)."""
    def build(bf16):
        model = HMViT(serving_config(dict(cfg, remat=False), bf16=bf16))
        model.load_state_dict(state_dict)
        model = model.to(dev, torch.bfloat16) if bf16 else model.to(dev)
        return model.eval()

    m32, m16 = build(False), build(True)
    rows = []
    for i, b in enumerate(batches):
        hints = serving_hints(b["mode"][0].cpu().numpy(),
                              int(b["agent_mask"][0].sum()))
        b16 = {k: (v.to(torch.bfloat16) if v.dtype == torch.float32
                   and k not in GEOMETRY_KEYS else v) for k, v in b.items()}
        with torch.no_grad():
            with strict_fp32():
                o32 = m32(b, **hints)
            o16 = m16(b16, **hints)
        s32 = torch.sigmoid(o32["psm"].float())
        diff = (torch.sigmoid(o16["psm"].float()) - s32).abs()
        live = s32 > SCORE_THRESHOLD
        rm_scale = max(1.0, float(o32["rm"].abs().max()))
        rows.append({
            "frame": i,
            "max_abs_sigmoid_psm": float(diff.max()),
            "mean_abs_sigmoid_psm": float(diff.mean()),
            "max_abs_sigmoid_psm_live": (float(diff[live].max())
                                         if live.any() else None),
            "live_anchors": int(live.sum()),
            "max_sigmoid_fp32": float(s32.max()),
            "max_abs_logit": float((o16["psm"].float()
                                    - o32["psm"].float()).abs().max()),
            "max_abs_rm_over_scale": float((o16["rm"].float()
                                            - o32["rm"].float()).abs().max())
            / rm_scale,
            "bar": BAR})
    return rows


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    res = prod_overfit.run(argv)
    dev = res["batches"][0]["mode"].device
    state_dict = {k: v.detach()
                  for k, v in res["state"].model.state_dict().items()}
    where = res["summary"]["card"]
    rows = bar_readings(state_dict, res["cfg"], res["batches"], dev)
    for row in rows:
        print(json.dumps(dict(row, card=where)), flush=True)
    worst = max(r["max_abs_sigmoid_psm"] for r in rows)
    print(f"bf16 bar on the gate's weights: worst max |sigmoid(psm) "
          f"difference| {worst:.3e} against {BAR} on {where}", flush=True)
    return rows


if __name__ == "__main__":
    main()
