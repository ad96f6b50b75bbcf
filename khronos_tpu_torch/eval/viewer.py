"""4D map viewer: standalone HTML export with robot/query time scrubbing.

Equivalent of the reference SpatioTemporalVisualizer + tkinter GUI
(khronos_ros/src/visualization/spatio_temporal_visualizer.cpp + gui.py,
SURVEY.md §2.4): loads a `.4dmap`, interactive robot-time x query-time
playback (modes ROBOT / QUERY / ONLINE), mesh + object bboxes colored by
presence, dynamic trajectories, agent trajectory. Instead of RViz + ROS
services, this emits ONE self-contained .html file (no external assets —
embedded data + a small canvas software renderer with orbit controls), per
SURVEY.md §7.6 "lightweight web/notebook 4D viewer instead of RViz".

Copy of `khronos_tpu/eval/viewer.py` (host only): for the same map the file
is the reference's, byte for byte.
"""

from __future__ import annotations

import base64
import json
import zlib

import numpy as np

from khronos_tpu_torch.stm.spatio_temporal_map import SpatioTemporalMap


def _pack(arr: np.ndarray) -> str:
    raw = np.ascontiguousarray(arr).tobytes()
    return base64.b64encode(zlib.compress(raw, 6)).decode()


def export_html(stm: SpatioTemporalMap, path: str, max_points: int = 120000) -> None:
    """Write a standalone interactive viewer for the 4D map."""
    snaps = []
    # rebase all display times to the map's first stamp: epoch-scale bag
    # stamps (~1.7e9 s) would quantize to ~128 s in the float32 time fields
    t0_ns = stm.earliest_ns()
    for stamp, snap in zip(stm.stamps_ns, stm.snapshots):
        mesh = snap.mesh
        V = mesh.num_vertices
        sel = np.arange(V)
        if V > max_points:
            sel = np.linspace(0, V - 1, max_points).astype(int)
        verts = mesh.vertices[sel].astype(np.float32)
        cols = (np.clip(mesh.colors[sel], 0, 1) * 255).astype(np.uint8)
        first_s = ((mesh.first_seen_ns[sel] - t0_ns) * 1e-9).astype(np.float32)
        objs = []
        for oid, o in sorted(snap.objects.items()):
            objs.append(
                {
                    "id": oid,
                    "cat": int(o.semantic_category),
                    "dyn": bool(o.is_dynamic),
                    "bbox": [o.bbox_min.tolist(), o.bbox_max.tolist()],
                    "t0": (o.first_observed_ns[0] - t0_ns) * 1e-9,
                    "t1": (o.last_observed_ns[-1] - t0_ns) * 1e-9,
                    "traj": np.asarray(o.trajectory_positions, np.float32).reshape(-1, 3).tolist()
                    if o.is_dynamic
                    else [],
                    "traj_t": [(s - t0_ns) * 1e-9 for s in o.trajectory_stamps_ns],
                }
            )
        agents = np.asarray(
            [a.t_w_b for a in snap.agents], np.float32
        ).reshape(-1, 3)
        agent_t = np.asarray([(a.stamp_ns - t0_ns) * 1e-9 for a in snap.agents], np.float32)
        places = []
        if snap.places is not None:
            for n in snap.places.nodes:
                places.append({"p": n.position.tolist(), "d": n.distance, "room": n.room_id})
        snaps.append(
            {
                "stamp": (stamp - t0_ns) * 1e-9,
                "n": len(verts),
                "verts": _pack(verts),
                "cols": _pack(cols),
                "first": _pack(first_s),
                "objects": objs,
                "agents": agents.tolist(),
                "agent_t": agent_t.tolist(),
                "places": places,
            }
        )
    payload = json.dumps(snaps)
    html = _TEMPLATE.replace("__DATA__", payload)
    with open(path, "w") as fh:
        fh.write(html)


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>khronos_tpu 4D map</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;left:10px;top:10px;background:#000a;padding:10px;border-radius:8px;width:330px}
 input[type=range]{width:200px;vertical-align:middle}
 canvas{display:block}
 .lbl{display:inline-block;width:90px}
</style></head><body>
<canvas id="cv"></canvas>
<div id="hud">
 <div><span class="lbl">robot time</span><input id="rt" type="range" min="0" max="1000" value="1000"><span id="rtv"></span></div>
 <div><span class="lbl">query time</span><input id="qt" type="range" min="0" max="1000" value="1000"><span id="qtv"></span></div>
 <div><span class="lbl">mode</span><select id="mode"><option>robot</option><option>query</option><option>online</option></select>
  <button id="play">play</button></div>
 <div><label><input id="showPlaces" type="checkbox" checked>places/rooms</label>
  <label><input id="showTraj" type="checkbox" checked>trajectories</label></div>
 <div id="info"></div>
 <div style="opacity:.6">drag: orbit &middot; wheel: zoom &middot; shift-drag: pan</div>
</div>
<script>
const RAW=__DATA__;
function unpack(b64,Type){const bin=atob(b64);const arr=new Uint8Array(bin.length);
 for(let i=0;i<bin.length;i++)arr[i]=bin.charCodeAt(i);
 const inflated=pako_inflate(arr);return new Type(inflated.buffer);}
// minimal zlib inflate (via DecompressionStream when available)
async function inflateAsync(arr){const ds=new DecompressionStream('deflate');
 const s=new Blob([arr]).stream().pipeThrough(ds);
 const buf=await new Response(s).arrayBuffer();return new Uint8Array(buf);}
let SNAPS=[];
(async()=>{
 for(const s of RAW){
  const v=await inflateAsync(b64ToArr(s.verts));
  const c=await inflateAsync(b64ToArr(s.cols));
  const f=await inflateAsync(b64ToArr(s.first));
  SNAPS.push({...s,verts:new Float32Array(v.buffer),cols:new Uint8Array(c.buffer),
              first:new Float32Array(f.buffer)});
 }
 init();
})();
function b64ToArr(b64){const bin=atob(b64);const a=new Uint8Array(bin.length);
 for(let i=0;i<bin.length;i++)a[i]=bin.charCodeAt(i);return a;}
const cv=document.getElementById('cv'),ctx=cv.getContext('2d');
let W,H;function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;}resize();
addEventListener('resize',()=>{resize();draw();});
let yaw=0.8,pitch=0.5,dist=14,cx=0,cy=0,cz=1,panx=0,pany=0;
let drag=null;
cv.onmousedown=e=>drag={x:e.clientX,y:e.clientY,shift:e.shiftKey};
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;drag.x=e.clientX;drag.y=e.clientY;
 if(drag.shift){panx+=dx*0.01*dist/10;pany+=dy*0.01*dist/10;}else{yaw+=dx*0.008;pitch+=dy*0.008;}
 draw();});
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);draw();e.preventDefault();};
const rt=document.getElementById('rt'),qt=document.getElementById('qt');
const rtv=document.getElementById('rtv'),qtv=document.getElementById('qtv');
rt.oninput=qt.oninput=()=>draw();
document.getElementById('mode').onchange=()=>draw();
document.getElementById('showPlaces').onchange=()=>draw();
document.getElementById('showTraj').onchange=()=>draw();
let playing=false;
document.getElementById('play').onclick=()=>{playing=!playing;if(playing)tick();};
function tick(){if(!playing)return;
 const m=document.getElementById('mode').value;
 const slider=(m==='query')?qt:rt;
 slider.value=(+slider.value+4)%1001; if(m==='online'){qt.value=rt.value;}
 draw();requestAnimationFrame(tick);}
function tmax(){return SNAPS.length?SNAPS[SNAPS.length-1].stamp:1;}
function proj(x,y,z){
 x-=cx;y-=cy;z-=cz;
 const cyaw=Math.cos(yaw),syaw=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 let X=cyaw*x+syaw*y, Y=-syaw*x+cyaw*y;
 let Z=cp*z-sp*Y, Yr=sp*z+cp*Y;
 const d=Yr+dist; if(d<=0.1)return null;
 const s=(H*0.9)/d;
 return [W/2+(X+panx)*s, H/2-(Z-pany)*s, d];}
function roomColor(r){const h=(r*137)%360;return `hsl(${h},60%,55%)`;}
function init(){rtv.textContent='';draw();}
function draw(){
 if(!SNAPS.length)return;
 const T=tmax();
 const rts=+rt.value/1000*T, qts=+qt.value/1000*T;
 rtv.textContent=rts.toFixed(1)+'s'; qtv.textContent=qts.toFixed(1)+'s';
 // pick snapshot: latest with stamp <= rts (else first)
 let s=SNAPS[0];for(const sn of SNAPS)if(sn.stamp<=rts+1e-6)s=sn;
 ctx.fillStyle='#111';ctx.fillRect(0,0,W,H);
 const mode=document.getElementById('mode').value;
 const q=(mode==='robot')?rts:qts;
 // mesh points known by robot time rts
 const n=s.n;
 for(let i=0;i<n;i++){
  if(s.first[i]>rts)continue;
  const p=proj(s.verts[3*i],s.verts[3*i+1],s.verts[3*i+2]);
  if(!p)continue;
  ctx.fillStyle=`rgb(${s.cols[3*i]},${s.cols[3*i+1]},${s.cols[3*i+2]})`;
  const r=Math.max(1,3-p[2]*0.1);
  ctx.fillRect(p[0],p[1],r,r);
 }
 // objects present at q
 let nObj=0;
 for(const o of s.objects){
  if(o.t0>rts)continue;
  const present=(q>=o.t0&&q<=o.t1);
  ctx.strokeStyle=o.dyn?'#ff5050':(present?'#40ff80':'#996600');
  ctx.lineWidth=present?2:1;
  drawBox(o.bbox[0],o.bbox[1]);
  nObj++;
  if(o.dyn&&document.getElementById('showTraj').checked){
   ctx.strokeStyle='#ff8080';ctx.beginPath();let started=false;
   for(let k=0;k<o.traj.length;k++){
    if(o.traj_t[k]>q)break;
    const p=proj(o.traj[k][0],o.traj[k][1],o.traj[k][2]);if(!p)continue;
    if(!started){ctx.moveTo(p[0],p[1]);started=true;}else ctx.lineTo(p[0],p[1]);}
   ctx.stroke();}
 }
 // agent trajectory up to rts
 if(document.getElementById('showTraj').checked){
  ctx.strokeStyle='#50b0ff';ctx.lineWidth=2;ctx.beginPath();let st=false;
  for(let k=0;k<s.agents.length;k++){
   if(s.agent_t[k]>rts)break;
   const p=proj(s.agents[k][0],s.agents[k][1],s.agents[k][2]);if(!p)continue;
   if(!st){ctx.moveTo(p[0],p[1]);st=true;}else ctx.lineTo(p[0],p[1]);}
  ctx.stroke();}
 // places
 if(document.getElementById('showPlaces').checked&&s.places){
  for(const pl of s.places){
   const p=proj(pl.p[0],pl.p[1],pl.p[2]);if(!p)continue;
   ctx.fillStyle=roomColor(pl.room);
   ctx.beginPath();ctx.arc(p[0],p[1],4,0,6.28);ctx.fill();}}
 document.getElementById('info').textContent=
  `snapshot @${s.stamp.toFixed(1)}s | ${n} pts | ${nObj} objects | ${(s.places||[]).length} places`;
}
function drawBox(mn,mx){
 const c=[[mn[0],mn[1],mn[2]],[mx[0],mn[1],mn[2]],[mx[0],mx[1],mn[2]],[mn[0],mx[1],mn[2]],
          [mn[0],mn[1],mx[2]],[mx[0],mn[1],mx[2]],[mx[0],mx[1],mx[2]],[mn[0],mx[1],mx[2]]];
 const E=[[0,1],[1,2],[2,3],[3,0],[4,5],[5,6],[6,7],[7,4],[0,4],[1,5],[2,6],[3,7]];
 ctx.beginPath();
 for(const[a,b]of E){const pa=proj(...c[a]),pb=proj(...c[b]);
  if(!pa||!pb)continue;ctx.moveTo(pa[0],pa[1]);ctx.lineTo(pb[0],pb[1]);}
 ctx.stroke();}
// tiny fallback if DecompressionStream missing
function pako_inflate(){throw new Error('unused');}
</script></body></html>
"""
