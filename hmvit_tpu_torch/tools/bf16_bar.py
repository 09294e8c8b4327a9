"""The north star's bf16 bar on trained weights: run the accuracy gate
(:mod:`hmvit_tpu_torch.prod_overfit`, the same flags), then load its
trained weights into the bf16 split server (every layer in bfloat16, the
serving hints of each frame's fleet) and the fp32 forward, and compare
them on the gate's fixture frames: max |sigmoid(psm) difference| against
1.8e-4, beside the logits, the anchors over the score threshold and rm.

    python -m hmvit_tpu_torch.tools.bf16_bar [prod_overfit flags]
        [--fp32_stage lidar,camera,fusion,decoder]

One JSON line a frame, then the worst; on the card unless ``--cpu``.
``--fp32_stage`` attributes the spread by stage: for each stage it
names (comma-separated), the same reading again with that one stage of
the bf16 server kept in float32 (its weights, and its compute dtype in
the configuration) and every other stage as it is; the inputs keep the
server's casts.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import prod_overfit
from ..models.hmvit import HMViT
from ..serving import GEOMETRY_KEYS, serving_config, serving_hints
from ..utils.precision import strict_fp32

BAR = 1.8e-4
SCORE_THRESHOLD = 0.27
# the server's stages and the submodule that holds each
STAGES = {"lidar": "lidar_encoder", "camera": "camera_encoder",
          "fusion": "fusion", "decoder": "HeteroDecoder_0"}


def stage_fp32_config(cfg: dict, stage: str) -> dict:
    """The bf16 server's configuration ``cfg`` with ``stage``'s compute
    dtype float32 (a copy)."""
    import copy

    cfg = copy.deepcopy(cfg)
    if stage == "lidar":
        cfg["lidar"].pop("compute_dtype", None)
    elif stage == "camera":
        cfg["camera"]["compute_dtype"] = "float32"
    elif stage == "fusion":
        cfg["hetero_fusion"]["hetero_fusion_block"]["compute_dtype"] = \
            "float32"
    elif stage == "decoder":
        cfg["hetero_decoder"].pop("compute_dtype", None)
    else:
        raise ValueError(f"unknown stage {stage!r}; stages: {list(STAGES)}")
    return cfg


def bar_readings(state_dict: dict, cfg: dict, batches, dev,
                 fp32_stage: str | None = None) -> list:
    """One reading a frame of the bf16 split server against the fp32
    forward of the same weights (``batches``: float32 device batches of
    one frame each); with ``fp32_stage``, that stage of the server in
    float32."""
    def build(bf16):
        scfg = serving_config(dict(cfg, remat=False), bf16=bf16)
        if bf16 and fp32_stage:
            scfg = stage_fp32_config(scfg, fp32_stage)
        model = HMViT(scfg)
        model.load_state_dict(state_dict)
        model = model.to(dev, torch.bfloat16) if bf16 else model.to(dev)
        if bf16 and fp32_stage:
            getattr(model, STAGES[fp32_stage]).float()
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
            "fp32_stage": fp32_stage,
            "bar": BAR})
    return rows


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser("bf16 bar on the gate's weights",
                                allow_abbrev=False)
    p.add_argument("--fp32_stage", default="",
                   help="comma-separated stages read again in float32: "
                        + ", ".join(STAGES))
    args, gate_argv = p.parse_known_args(argv)
    stages = [s for s in args.fp32_stage.split(",") if s]
    for stage in stages:
        if stage not in STAGES:
            raise SystemExit(f"--fp32_stage: unknown stage {stage!r}; "
                             f"stages: {list(STAGES)}")
    res = prod_overfit.run(gate_argv)
    dev = res["batches"][0]["mode"].device
    state_dict = {k: v.detach()
                  for k, v in res["state"].model.state_dict().items()}
    where = res["summary"]["card"]
    rows = []
    for stage in [None] + stages:
        got = bar_readings(state_dict, res["cfg"], res["batches"], dev,
                           stage)
        for row in got:
            print(json.dumps(dict(row, card=where)), flush=True)
        worst = max(r["max_abs_sigmoid_psm"] for r in got)
        print(f"bf16 bar on the gate's weights"
              + (f", {stage} in float32" if stage else "")
              + f": worst max |sigmoid(psm) difference| {worst:.3e} "
              f"against {BAR} on {where}", flush=True)
        rows += got
    return rows


if __name__ == "__main__":
    main()
