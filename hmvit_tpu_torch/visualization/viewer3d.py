"""Interactive 3D scene viewer as one self-contained HTML file (port of
``hmvit_tpu/visualization/viewer3d.py``, numpy and json only; its output
is byte-equal to the JAX module's for the same inputs).

Every frame is embedded as JSON (points rounded to 0.01, at most 120 000
a frame, evenly sub-sampled) and drawn by a dependency-free canvas
renderer with orbit / pan / zoom and a frame slider with autoplay.  Open
the file in any browser: no server, no network.

    from hmvit_tpu_torch.visualization import viewer3d
    viewer3d.export_scene_html("scene.html", points, pred_corners,
                               gt_corners)
    viewer3d.export_sequence_html("seq.html", frames)   # list of dicts
"""
from __future__ import annotations

import json
import os

import numpy as np

# box corner wireframe: 4 bottom edges, 4 top edges, 4 pillars
_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def _frame_payload(points, pred_corners=None, gt_corners=None,
                   scores=None, max_points: int = 120000) -> dict:
    """Round + downsample one frame into a compact JSON-able dict."""
    pts = np.asarray(points, np.float32).reshape(-1, points.shape[-1])
    if len(pts) > max_points:
        sel = np.linspace(0, len(pts) - 1, max_points).astype(np.int64)
        pts = pts[sel]
    payload = {
        "pts": np.round(pts[:, :3], 2).ravel().tolist(),
    }
    if pts.shape[1] > 3:
        inten = pts[:, 3]
        lo, hi = float(inten.min(initial=0.0)), float(inten.max(initial=1.0))
        inten = (inten - lo) / (hi - lo + 1e-6)
        payload["inten"] = np.round(inten, 3).tolist()
    for key, corners in (("pred", pred_corners), ("gt", gt_corners)):
        if corners is not None and len(corners):
            c = np.asarray(corners, np.float32).reshape(-1, 8, 3)
            payload[key] = np.round(c, 2).reshape(-1).tolist()
    if scores is not None and len(scores):
        payload["scores"] = np.round(np.asarray(scores, np.float32),
                                     3).tolist()
    return payload


def export_scene_html(path: str, points, pred_corners=None,
                      gt_corners=None, scores=None, title: str = "scene"):
    """One-frame interactive viewer (points + wireframe boxes)."""
    return export_sequence_html(
        path,
        [{"points": points, "pred_corners": pred_corners,
          "gt_corners": gt_corners, "scores": scores}],
        title=title)


def export_sequence_html(path: str, frames, title: str = "sequence"):
    """Multi-frame interactive viewer with a slider + autoplay.

    frames: list of dicts with keys ``points`` (N, >=3) and optionally
    ``pred_corners`` / ``gt_corners`` (K, 8, 3) and ``scores`` (K,).
    """
    payload = [
        _frame_payload(f["points"], f.get("pred_corners"),
                       f.get("gt_corners"), f.get("scores"))
        for f in frames
    ]
    doc = (_TEMPLATE
           .replace("__TITLE__", title)
           .replace("__EDGES__", json.dumps(_EDGES))
           .replace("__FRAMES__", json.dumps(payload)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(doc)
    return path


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
html,body{margin:0;height:100%;background:#111;color:#ccc;
font:12px monospace;overflow:hidden}
#c{display:block;width:100vw;height:100vh;cursor:grab}
#hud{position:fixed;left:10px;top:10px;user-select:none}
#bar{position:fixed;left:10px;bottom:10px;right:10px;display:flex;
gap:8px;align-items:center}
#slider{flex:1}
button{background:#222;color:#ccc;border:1px solid #444;
font:12px monospace;padding:2px 10px;cursor:pointer}
.gt{color:#4c4}.pred{color:#e55}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">__TITLE__ — drag orbit · shift-drag pan · wheel zoom ·
space play<br><span class="gt">green = ground truth</span> ·
<span class="pred">red = prediction</span><br><span id="info"></span></div>
<div id="bar"><button id="play">&#9654;</button>
<input id="slider" type="range" min="0" max="0" value="0">
<span id="fno"></span></div>
<script>
"use strict";
const FRAMES=__FRAMES__, EDGES=__EDGES__;
const cv=document.getElementById("c"), ctx=cv.getContext("2d");
let az=-2.2, el=0.9, dist=90, cx=0, cy=0, cz=0, fi=0, playing=false;
function resize(){cv.width=innerWidth*devicePixelRatio;
cv.height=innerHeight*devicePixelRatio;}
addEventListener("resize",()=>{resize();draw();});resize();
const slider=document.getElementById("slider");
slider.max=FRAMES.length-1;
slider.oninput=()=>{fi=+slider.value;draw();};
document.getElementById("play").onclick=toggle;
function toggle(){playing=!playing;
document.getElementById("play").innerHTML=playing?"&#10074;&#10074;":"&#9654;";
if(playing)tick();}
function tick(){if(!playing)return;fi=(fi+1)%FRAMES.length;
slider.value=fi;draw();setTimeout(tick,120);}
addEventListener("keydown",e=>{if(e.code==="Space"){toggle();
e.preventDefault();}});
let drag=null;
cv.onmousedown=e=>{drag={x:e.clientX,y:e.clientY,pan:e.shiftKey};};
addEventListener("mouseup",()=>drag=null);
addEventListener("mousemove",e=>{if(!drag)return;
const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
const ca=Math.cos(az),sa=Math.sin(az),ce=Math.cos(el),se=Math.sin(el);
if(drag.pan){const s=dist/600;
// right = (-sa, ca, 0); up = (-se*ca, -se*sa, ce)
cx+=sa*dx*s-se*ca*dy*s;cy-=ca*dx*s+se*sa*dy*s;cz+=ce*dy*s;}
else{az+=dx*0.008;el=Math.min(1.55,Math.max(-1.55,el+dy*0.008));}
drag.x=e.clientX;drag.y=e.clientY;draw();});
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);
dist=Math.min(800,Math.max(5,dist));draw();e.preventDefault();};
function proj(x,y,z){
// world -> orbit camera: yaw about z, pitch, eye at +dist
x-=cx;y-=cy;z-=cz;
const ca=Math.cos(az),sa=Math.sin(az),ce=Math.cos(el),se=Math.sin(el);
const x1=ca*x+sa*y, y1=-sa*x+ca*y;        // x1 depth-ward, y1 right
const x2=ce*x1+se*z, z2=-se*x1+ce*z;      // pitch; z2 screen-up
const depth=dist-x2;
if(depth<1)return null;
const f=cv.height*0.9/depth;
return [cv.width/2+y1*f, cv.height/2-z2*f, depth];}
function draw(){
const fr=FRAMES[fi];
ctx.fillStyle="#111";ctx.fillRect(0,0,cv.width,cv.height);
const pts=fr.pts, n=pts.length/3, inten=fr.inten;
for(let i=0;i<n;i++){
const p=proj(pts[3*i],pts[3*i+1],pts[3*i+2]);
if(!p)continue;
const t=inten?inten[i]:Math.min(1,Math.max(0,(pts[3*i+2]+3)/4));
ctx.fillStyle=`rgb(${40+120*t|0},${80+140*t|0},${160+95*t|0})`;
const s=Math.max(1,3-p[2]/120);
ctx.fillRect(p[0],p[1],s,s);}
drawBoxes(fr.gt,"#4c4");drawBoxes(fr.pred,"#e55",fr.scores);
document.getElementById("fno").textContent=
(fi+1)+"/"+FRAMES.length;
document.getElementById("info").textContent=
n+" pts · "+((fr.pred||[]).length/24|0)+" pred · "+
((fr.gt||[]).length/24|0)+" gt";}
function drawBoxes(flat,color,scores){if(!flat)return;
ctx.strokeStyle=color;ctx.lineWidth=devicePixelRatio;
ctx.fillStyle=color;
const nb=flat.length/24;
for(let b=0;b<nb;b++){
const P=[];
for(let k=0;k<8;k++)P.push(proj(flat[24*b+3*k],flat[24*b+3*k+1],
flat[24*b+3*k+2]));
ctx.beginPath();
for(const[a,bb]of EDGES){if(!P[a]||!P[bb])continue;
ctx.moveTo(P[a][0],P[a][1]);ctx.lineTo(P[bb][0],P[bb][1]);}
ctx.stroke();
if(scores&&P[4])ctx.fillText(scores[b].toFixed(2),P[4][0],P[4][1]-4);}}
draw();
</script></body></html>
"""
