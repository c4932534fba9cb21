"""Self-contained interactive 3D map viewer (single HTML file, no deps).

The reference shows a LIVE interactive 3D window — camera frustum, SRBA
map, stereo viewports, BoW query-score bars (CDisplayWindow3D setup at
reference src/CSRBAStereoSLAMEstimator.cpp:1262-1338; score bars
``show_kf_numbers`` at srba-stereo-slam_utils.cpp:101-151). The target
environments here are headless, so the interactive equivalent is an
artifact: ``finalize`` writes ``map_viewer.html`` — the full map
(trajectory, landmarks, typed kf2kf edges, per-KF camera frusta, ground
truth when known, the BoW score bars) embedded as JSON in one HTML file
with a vanilla-JS orbit/zoom/pan renderer (canvas 2D, painter-sorted).
Open it in any browser, no server and no network access required.
"""

from __future__ import annotations

import json

import numpy as np

from srba_slam_tpu_torch.utils import se3_np

_MAX_LMS = 20000  # keep the embedded JSON bounded (~uniform subsample over)


def _frustum_segments(pose: np.ndarray, scale: float = 0.6) -> list:
    """Line segments of a small camera frustum at a world pose [6]."""
    R, t = se3_np.exp(np.asarray(pose, np.float64))
    w, h, d = 0.5 * scale, 0.35 * scale, 0.8 * scale
    corners = np.array([
        [0.0, 0.0, 0.0],
        [-w, -h, d], [w, -h, d], [w, h, d], [-w, h, d],
    ])
    pts = corners @ R.T + t
    idx = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return [[pts[a].tolist(), pts[b].tolist()] for a, b in idx]


def build_map_data(poses: np.ndarray, landmarks=None, edges=None,
                   gt_poses=None, query_scores=None, query_score_th=None,
                   kf_frames=None,
                   title: str = "srba_slam_tpu_torch map viewer") -> dict:
    """The viewer's JSON payload. ``poses``: [N, 6] world keyframe poses
    (rotvec+trans); ``edges``: iterable of (u, v, kind) with kind in
    {"submap", "base", "lc"}; ``kf_frames``: per-KF source frame index."""
    poses = np.asarray(poses, np.float64).reshape(-1, 6)
    lms = None
    if landmarks is not None and len(landmarks):
        lms = np.asarray(landmarks, np.float64).reshape(-1, 3)
        if len(lms) > _MAX_LMS:
            lms = lms[:: len(lms) // _MAX_LMS + 1]
    return {
        "title": title,
        "traj": np.round(poses[:, 3:], 4).tolist(),
        "frusta": [_frustum_segments(p) for p in poses],
        "lms": np.round(lms, 3).tolist() if lms is not None else [],
        "edges": [[int(u), int(v), str(k)] for (u, v, k) in (edges or [])],
        "gt": (np.round(np.asarray(gt_poses, np.float64)[:, 3:], 4).tolist()
               if gt_poses is not None else []),
        "qs": ([float(s) for s in query_scores]
               if query_scores is not None else []),
        "qth": (None if query_score_th is None else float(query_score_th)),
        "kf_frames": ([int(f) for f in kf_frames]
                      if kf_frames is not None else []),
    }


def write_map_viewer(path: str, poses: np.ndarray, landmarks=None,
                     edges=None, gt_poses=None, query_scores=None,
                     query_score_th=None, kf_frames=None,
                     title: str = "srba_slam_tpu_torch map viewer") -> bool:
    """Write the interactive viewer with the map embedded (offline file)."""
    data = build_map_data(poses, landmarks=landmarks, edges=edges,
                          gt_poses=gt_poses, query_scores=query_scores,
                          query_score_th=query_score_th, kf_frames=kf_frames,
                          title=title)
    html = _TEMPLATE.replace("__DATA__", json.dumps(data))
    with open(path, "w") as f:
        f.write(html)
    return True


def write_live_viewer(path: str) -> bool:
    """Write the LIVE variant: same renderer, but the payload is fetched
    from a sibling ``live_map.json`` and re-polled every second — the
    in-browser equivalent of the reference's live CDisplayWindow3D updates
    (reference .cpp:1262-1338) for headless runs, served by
    utils/live_server (``--serve``)."""
    with open(path, "w") as f:
        f.write(_TEMPLATE.replace("__DATA__", "null"))
    return True


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>srba_slam_tpu_torch map</title>
<style>
 html,body{margin:0;height:100%;background:#111;color:#ddd;
   font:12px system-ui,sans-serif;overflow:hidden}
 #c{display:block;width:100%;height:100%}
 #hud{position:fixed;top:8px;left:10px;background:#000a;padding:6px 10px;
   border-radius:6px;line-height:1.5;pointer-events:none;white-space:pre}
 #bars{position:fixed;right:10px;bottom:10px;background:#000a;
   padding:6px 10px;border-radius:6px}
 #help{position:fixed;bottom:8px;left:10px;color:#888}
</style></head><body>
<canvas id="c"></canvas><div id="hud"></div>
<canvas id="bars" width="260" height="90"></canvas>
<div id="help">drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan
 &nbsp; click: nearest keyframe</div>
<script>
const D0 = __DATA__;           // embedded payload, or null => LIVE mode
const live = (D0 === null);
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let D=null, traj=[], lms=[], gt=[];
let ctr=[0,0,0], ext=1, yaw=-0.9, pitch=0.5, dist=1, pan=[0,0], sel=-1;
let userMoved=false;
function setData(d){
  D=d; traj=D.traj; lms=D.lms; gt=D.gt;
  if(userMoved) return;        // keep the user's camera once they moved it
  let pts=traj.concat(gt);
  if(!pts.length) pts=[[0,0,0]];
  ctr=[0,0,0];
  for(const p of pts){ctr[0]+=p[0];ctr[1]+=p[1];ctr[2]+=p[2];}
  ctr=ctr.map(v=>v/pts.length);
  ext=1; for(const p of pts){ext=Math.max(ext,
    Math.hypot(p[0]-ctr[0],p[1]-ctr[1],p[2]-ctr[2]));}
  dist=ext*2.8;
}
function proj(p){
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),
        sp=Math.sin(pitch);
  let x=p[0]-ctr[0], y=p[1]-ctr[1], z=p[2]-ctr[2];
  let x1= cy*x+sy*y, y1=-sy*x+cy*y;            // yaw about world z
  let y2= cp*y1-sp*z, z2= sp*y1+cp*z;          // pitch
  const zc = z2 + dist;                         // camera looks along -z2
  if(zc < 0.05*ext) return null;
  const f = 0.9*Math.min(cv.width,cv.height)/ (zc/dist);
  return [cv.width/2 + f*(x1/dist) + pan[0],
          cv.height/2 - f*(y2/dist) + pan[1], zc];
}
function line(a,b,st,wd,dash){const pa=proj(a),pb=proj(b);
  if(!pa||!pb)return; ctx.strokeStyle=st;ctx.lineWidth=wd;
  ctx.setLineDash(dash||[]);
  ctx.beginPath();ctx.moveTo(pa[0],pa[1]);ctx.lineTo(pb[0],pb[1]);
  ctx.stroke();ctx.setLineDash([]);}
function draw(){
  cv.width=innerWidth; cv.height=innerHeight;
  ctx.fillStyle='#111'; ctx.fillRect(0,0,cv.width,cv.height);
  if(!D){ctx.fillStyle='#888';
    ctx.fillText('waiting for live_map.json ...',20,30);return;}
  // axes triad at scene center
  const ax=[[ext/3,0,0],[0,ext/3,0],[0,0,ext/3]],
        an=['#c44','#4a4','#48c'];
  for(let i=0;i<3;i++) line(ctr,[ctr[0]+ax[i][0],ctr[1]+ax[i][1],
    ctr[2]+ax[i][2]],an[i],1.5);
  ctx.fillStyle='#999';
  for(const p of lms){const q=proj(p); if(q)ctx.fillRect(q[0],q[1],1.4,1.4);}
  if(gt.length>1)for(let i=1;i<gt.length;i++)
    line(gt[i-1],gt[i],'#3a3',1.2,[6,4]);
  for(const e of D.edges){
    const a=traj[e[0]], b=traj[e[1]];
    if(!a||!b)continue;
    line(a,b, e[2]=='lc' ? '#f33' : '#777', e[2]=='lc'?2.2:0.8);}
  for(let i=1;i<traj.length;i++) line(traj[i-1],traj[i],'#e66',1.6);
  for(const fr of D.frusta) for(const s of fr) line(s[0],s[1],'#49c',0.8);
  ctx.fillStyle='#fda';
  traj.forEach((p,i)=>{const q=proj(p);
    if(q){ctx.beginPath();ctx.arc(q[0],q[1],i==sel?5:2.6,0,7);ctx.fill();}});
  const hud=document.getElementById('hud');
  let t=D.title+(live?'  [LIVE]':'')+'\\n'
      +traj.length+' keyframes  '+lms.length+' landmarks  '+
        D.edges.length+' edges ('+
        D.edges.filter(e=>e[2]=='lc').length+' loop closures)';
  if(sel>=0){const p=traj[sel];
    t+='\\nKF '+sel+(D.kf_frames[sel]!=null?' (frame '+D.kf_frames[sel]+')':'')
      +'  xyz = '+p.map(v=>v.toFixed(2)).join(', ');}
  hud.textContent=t;
  // BoW score bars (last keyframe check)
  const bc=document.getElementById('bars'), b=bc.getContext('2d');
  b.clearRect(0,0,bc.width,bc.height);
  if(D.qs.length){const n=D.qs.length,
    mx=Math.max(...D.qs, D.qth||0, 1e-9), w=bc.width/n;
    b.fillStyle='#8ac';
    D.qs.forEach((s,i)=>b.fillRect(i*w+1,bc.height-14-(s/mx)*66,
      Math.max(1,w-2),(s/mx)*66));
    if(D.qth!=null){b.strokeStyle='#f55';
      const y=bc.height-14-(D.qth/mx)*66;
      b.beginPath();b.moveTo(0,y);b.lineTo(bc.width,y);b.stroke();}
    b.fillStyle='#ccc';b.fillText('BoW query scores (last check)',4,10);}
  else {b.fillStyle='#888';b.fillText('no BoW query recorded',4,12);}
}
let drag=null;
cv.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];userMoved=true;};
window.onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){pan[0]+=dx;pan[1]+=dy;}
  else{yaw+=dx*0.008;
       pitch=Math.max(-1.55,Math.min(1.55,pitch+dy*0.008));}
  drag=[e.clientX,e.clientY,drag[2]]; draw();};
window.onmouseup=e=>{
  if(drag&&Math.abs(e.clientX-drag[0])<3&&Math.abs(e.clientY-drag[1])<3){
    let best=-1,bd=144;
    traj.forEach((p,i)=>{const q=proj(p);if(!q)return;
      const d=(q[0]-e.clientX)**2+(q[1]-e.clientY)**2;
      if(d<bd){bd=d;best=i;}});
    sel=best; draw();}
  drag=null;};
cv.onwheel=e=>{e.preventDefault();userMoved=true;
  dist*=Math.exp(e.deltaY*0.0012); dist=Math.max(ext*0.2,dist); draw();};
window.onresize=draw;
if(live){
  const poll=()=>fetch('live_map.json?t='+Date.now())
    .then(r=>r.json()).then(d=>{setData(d);draw();}).catch(()=>{});
  poll(); setInterval(poll, 1000);
} else { setData(D0); }
draw();
</script></body></html>
"""
