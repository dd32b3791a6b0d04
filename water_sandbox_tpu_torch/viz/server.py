"""Browser-based live viewer: 3-D point cloud with a pan-orbit camera,
velocity coloring, live parameter tuning from the keyboard — the
counterpart of ``water_sandbox_tpu/viz/server.py``, with the same page.

The reference's presentation layer: pan-orbit camera (src/camera.rs:44-61
— drag orbits, wheel zooms, shift-drag pans), container wireframe gizmo
(src/fluid_container.rs:93-103), the HUD keymap (src/hud.rs:130-165 via
runtime/keymap.py), the velocity→color mapping the reference left
commented out (src/fluid_compute.rs:489-502), and a shaded-sphere mode
('v' key) — lit sphere impostors with painter's-algorithm depth sorting,
the canvas equivalent of the reference's PBR icosphere render
(src/fluid_compute.rs:444-465). Stdlib only (http.server + canvas JS);
the simulation steps on its device in the main thread and the browser
polls ~20 Hz for a subsampled positions/speed frame, or for a density
raster made on the device.

    python -m water_sandbox_tpu_torch.cli serve --scene dam-break-2d-4k \
        --port 8787

Threads: the main thread steps and snapshots; handler threads apply keys
and the mouse field through ``Simulation.tune``/``reset``/``pause``. Both
hold the Simulation's ``lock`` (the main thread around a frame's steps
and its reads, a handler around a key or a field change), so a reset or a
tune lands between two frames, never between two steps of one frame or
inside the first run's capture. ``ViewerServer.lock`` guards the frame
bytes only.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..runtime import keymap

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>water-sandbox-tpu</title><style>
body{margin:0;background:#0b0e14;color:#aab;font:12px monospace;overflow:hidden}
#hud{position:fixed;left:8px;top:8px;white-space:pre;pointer-events:none;
     text-shadow:0 0 4px #000}
#msg{position:fixed;left:8px;bottom:8px;color:#7c9;white-space:pre}
canvas{display:block}
</style></head><body>
<div id="hud"></div><div id="msg">drag orbit · wheel zoom · shift-drag pan ·
ctrl-drag repel · ctrl+shift-drag attract (mouse field) · v spheres/points ·
keys: 1/2 radius q/w pressure a/s near z/x density e/r viscosity 3/4 gravity
0/9 g-off/on space reset p pause</div>
<canvas id="c"></canvas><script>
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let yaw=-0.5,pitch=0.35,dist=0,panX=0,panY=0,frame=null;
function resize(){cv.width=innerWidth;cv.height=innerHeight;}
addEventListener('resize',resize);resize();
function b64f32(s){const b=atob(s),a=new Uint8Array(b.length);
 for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);return new Float32Array(a.buffer);}
function b64u8(s){const b=atob(s),a=new Uint8Array(b.length);
 for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);return a;}
const oc=document.createElement('canvas'),octx=oc.getContext('2d');
let rastXf=null;
async function poll(){try{
 const r=await fetch('/state.json');frame=await r.json();
 if(frame.mode==='raster'){frame.den=b64u8(frame.den);frame.spd=b64u8(frame.spd);}
 else{frame.pos=b64f32(frame.pos);frame.speed=b64f32(frame.speed);}
 if(!dist)dist=frame.extent*2.2;
 document.getElementById('hud').textContent=frame.hud;
}catch(e){} setTimeout(poll,50);}
poll();
function hsl2rgb(h,s,l){const a=s*Math.min(l,1-l);
 const f=n=>{const k=(n+h/30)%12;return l-a*Math.max(Math.min(k-3,9-k,1),-1);};
 return [f(0)*255,f(8)*255,f(4)*255];}
function drawRaster(w,h){
 const rw=frame.rw,rh=frame.rh;
 if(oc.width!==rw){oc.width=rw;oc.height=rh;}
 const id=octx.createImageData(rw,rh),px=id.data;
 for(let y=0;y<rh;y++)for(let x=0;x<rw;x++){
  const i=(rh-1-y)*rw+x, o=(y*rw+x)*4;         // raster row 0 = bottom
  const v=frame.den[i]/255, t=frame.spd[i]/255;
  const c=hsl2rgb(200-160*t,0.9,Math.min(0.08+0.72*v,0.8));
  px[o]=c[0];px[o+1]=c[1];px[o+2]=c[2];px[o+3]=255;}
 octx.putImageData(id,0,0);
 // fit the container footprint on screen, aspect preserved; wheel zooms
 const hx=frame.half[0],hy=frame.half[1];
 const s=0.9*Math.min(w/(2*hx),h/(2*hy))*(frame.extent*2.2/dist);
 const dw=2*hx*s,dh=2*hy*s,dx=w/2+panX-dw/2,dy=h/2+panY-dh/2;
 rastXf={dx:dx,dy:dy,dw:dw,dh:dh};
 ctx.imageSmoothingEnabled=true;
 ctx.drawImage(oc,dx,dy,dw,dh);
 ctx.strokeStyle='#31425c';ctx.strokeRect(dx,dy,dw,dh);
 drawField(p=>{const fx=(p[0]-(frame.center[0]-hx))/(2*hx),
   fy=(p[1]-(frame.center[1]-hy))/(2*hy);
   return [dx+fx*dw, dy+(1-fy)*dh, dw/(2*hx)];});
}
function drawField(toScreen){
 const f=frame.field; if(!f||!f.s)return;
 const q=toScreen(f.p); if(!q)return;
 ctx.strokeStyle=f.s>0?'#e06c75':'#98c379';
 ctx.beginPath();ctx.arc(q[0],q[1],Math.max(4,f.r*q[2]),0,2*Math.PI);
 ctx.stroke();
}
function draw(){requestAnimationFrame(draw);if(!frame)return;
 const w=cv.width,h=cv.height;ctx.fillStyle='#0b0e14';ctx.fillRect(0,0,w,h);
 if(frame.mode==='raster'){drawRaster(w,h);return;}
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 const f=0.9*Math.min(w,h), c=frame.center, is3d=frame.dim===3;
 function proj(x,y,z){x-=c[0];y-=c[1];z-=(c[2]||0);
  let X=cy*x+sy*z, Z=-sy*x+cy*z, Y=cp*y-sp*Z; Z=sp*y+cp*Z;
  const s=f/(dist+(is3d?Z:0));
  return [w/2+panX+X*s, h/2+panY-Y*s, s, Z];}
 // container wireframe (gizmo, fluid_container.rs:93-103)
 const hx=frame.half[0],hy=frame.half[1],hz=frame.half[2]||0,
       ca=Math.cos(frame.angle||0),sa=Math.sin(frame.angle||0);
 const corners=[];
 for(const ix of[-1,1])for(const iy of[-1,1])for(const iz of(is3d?[-1,1]:[0])){
  let x=ix*hx,z=iz*hz; const xr=ca*x+sa*z, zr=-sa*x+ca*z;
  corners.push([frame.center[0]+xr,frame.center[1]+iy*hy,(frame.center[2]||0)+zr]);}
 ctx.strokeStyle='#31425c';ctx.beginPath();
 const E=is3d?[[0,1],[0,2],[1,3],[2,3],[4,5],[4,6],[5,7],[6,7],[0,4],[1,5],[2,6],[3,7]]
             :[[0,1],[0,2],[1,3],[2,3]];
 for(const[a,b]of E){const p=proj(...corners[a]),q=proj(...corners[b]);
  ctx.moveTo(p[0],p[1]);ctx.lineTo(q[0],q[1]);}
 ctx.stroke();
 // rotator-ring gizmo (fluid_container.rs:54-68): a ring in the yaw
 // plane around the box, with a tick marking the current angle — unlike
 // the reference's (decorative-only) rings, this one tracks a container
 // that actually rotates
 if(is3d){
  const rr=1.06*Math.hypot(hx,hz);
  ctx.strokeStyle='#3d5a52';ctx.beginPath();
  for(let k=0;k<=48;k++){const t=k/48*2*Math.PI;
   const p=proj(frame.center[0]+rr*Math.cos(t),frame.center[1],
                (frame.center[2]||0)+rr*Math.sin(t));
   if(k===0)ctx.moveTo(p[0],p[1]);else ctx.lineTo(p[0],p[1]);}
  ctx.stroke();
  const a0=-(frame.angle||0);
  const t1=proj(frame.center[0]+rr*Math.cos(a0),frame.center[1],
                (frame.center[2]||0)+rr*Math.sin(a0));
  const t2=proj(frame.center[0]+1.12*rr*Math.cos(a0),frame.center[1],
                (frame.center[2]||0)+1.12*rr*Math.sin(a0));
  ctx.strokeStyle='#6fae9b';ctx.beginPath();
  ctx.moveTo(t1[0],t1[1]);ctx.lineTo(t2[0],t2[1]);ctx.stroke();
 }
 const n=frame.speed.length,P=frame.pos,vmax=frame.vmax||1;
 if(shaded){
  // shaded-sphere mode (v): lit sphere impostors + painter's depth sort —
  // the canvas answer to the reference's PbrBundle icospheres
  // (fluid_compute.rs:444-465). Sprites are cached per hue bucket.
  const pts=[];
  for(let i=0;i<n;i++){
   const p=proj(P[i*frame.dim],P[i*frame.dim+1],is3d?P[i*frame.dim+2]:0);
   const t=Math.min(frame.speed[i]/vmax,1);
   pts.push([p[0],p[1],p[3]||0,t,p[2]]);}
  if(is3d)pts.sort((a,b)=>b[2]-a[2]);       // far first
  for(const q of pts){
   const d=Math.max(2,q[4]*frame.radius*2);
   ctx.drawImage(sprite(q[3]),q[0]-d/2,q[1]-d/2,d,d);}
 }else{
  for(let i=0;i<n;i++){
   const p=proj(P[i*frame.dim],P[i*frame.dim+1],is3d?P[i*frame.dim+2]:0);
   const t=Math.min(frame.speed[i]/vmax,1);
   ctx.fillStyle=`hsl(${200-160*t},90%,${35+40*t}%)`;
   const r=Math.max(1,p[2]*frame.radius);
   ctx.fillRect(p[0]-r/2,p[1]-r/2,r,r);}
 }
 drawField(fp=>proj(fp[0],fp[1],is3d?(fp[2]||0):0));
}
let shaded=false;
const spriteCache=new Map();
function sprite(t){
 const k=Math.round(t*23);
 let s=spriteCache.get(k); if(s)return s;
 s=document.createElement('canvas');s.width=s.height=32;
 const g=s.getContext('2d');
 const hue=200-160*(k/23), l=35+30*(k/23);
 // light from upper-left: offset highlight + darkened limb (PBR-ish)
 const rg=g.createRadialGradient(12,10,2,16,16,16);
 rg.addColorStop(0,`hsl(${hue},85%,${Math.min(l+38,92)}%)`);
 rg.addColorStop(0.55,`hsl(${hue},90%,${l}%)`);
 rg.addColorStop(1,`hsl(${hue},95%,${Math.max(l-24,6)}%)`);
 g.fillStyle=rg;g.beginPath();g.arc(16,16,15.5,0,2*Math.PI);g.fill();
 spriteCache.set(k,s);return s;
}
// mouse-field: screen -> world (raster: container-plane affine; points 2D:
// inverse of the linear proj; points 3D: the camera-facing plane through
// the container center)
function world(px,py){
 const w=cv.width,h=cv.height;
 if(frame.mode==='raster'){
  if(!rastXf)return null;
  const fx=(px-rastXf.dx)/rastXf.dw, fy=1-(py-rastXf.dy)/rastXf.dh;
  return [frame.center[0]+(2*fx-1)*frame.half[0],
          frame.center[1]+(2*fy-1)*frame.half[1]];
 }
 const f=0.9*Math.min(w,h), s=f/dist;
 const X=(px-w/2-panX)/s, Y=-(py-h/2-panY)/s;
 if(frame.dim!==3)return [frame.center[0]+X, frame.center[1]+Y];
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 const y=Y*cp, Z0=-sp*Y, x=cy*X-sy*Z0, z=sy*X+cy*Z0;
 return [frame.center[0]+x, frame.center[1]+y, (frame.center[2]||0)+z];
}
let fieldDrag=0,lastSend=0;
function sendField(px,py){
 const now=performance.now(); if(now-lastSend<40)return; lastSend=now;
 const p=world(px,py); if(!p)return;
 fetch(`/field?x=${p[0].toFixed(4)}&y=${p[1].toFixed(4)}`+
       `&z=${(p[2]||0).toFixed(4)}&s=${fieldDrag===2?-20:20}`);
}
draw();
let drag=null;
cv.onmousedown=e=>{
 if(e.ctrlKey){fieldDrag=e.shiftKey?2:1;lastSend=0;
  sendField(e.clientX,e.clientY);e.preventDefault();return;}
 drag=[e.clientX,e.clientY,e.shiftKey];};
addEventListener('mouseup',()=>{drag=null;
 if(fieldDrag){fieldDrag=0;fetch('/field?off=1');}});
addEventListener('mousemove',e=>{
 if(fieldDrag){sendField(e.clientX,e.clientY);return;}
 if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){panX+=dx;panY+=dy;}else{yaw+=dx*0.008;
  pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.008));}
 drag=[e.clientX,e.clientY,drag[2]];});
addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);});
addEventListener('keydown',e=>{
 if(e.key==='v'){shaded=!shaded;
  document.getElementById('msg').textContent=
   shaded?'shaded spheres':'points';return;}
 if(e.key.length===1||e.key==='Escape')
  fetch('/key?k='+encodeURIComponent(e.key==='Escape'?'p':e.key))
   .then(r=>r.text()).then(t=>{if(t)document.getElementById('msg').textContent=t;});});
</script></body></html>"""


class ViewerServer:
    """Steps a Simulation continuously and serves frames + key handling."""

    def __init__(self, sim, host: str = "127.0.0.1", port: int = 8787,
                 max_points: int = 30000, steps_per_frame: int = 4,
                 render: str = "auto", raster_size=(480, 270)):
        self.sim = sim
        self.steps_per_frame = steps_per_frame
        self.lock = threading.Lock()
        n = sim.cfg.n
        stride = max(1, n // max_points)
        self.sel = np.arange(0, n, stride)
        # raster streaming (VERDICT r2 item 7): 100k+ scenes stream an
        # on-device density/speed raster (~130 KB/frame) instead of a
        # subsampled point cloud — the full fluid is visible, like the
        # reference's all-65k-particle render (fluid_compute.rs:444-465)
        if render == "auto":
            render = "raster" if n > max_points else "points"
        self.render = render
        self.raster_size = raster_size
        self.frame = {}
        self._stop = threading.Event()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    self._send(_PAGE.encode(), "text/html")
                elif url.path == "/state.json":
                    with viewer.lock:
                        body = viewer.frame.get("json", b"{}")
                    self._send(body, "application/json")
                elif url.path == "/key":
                    k = parse_qs(url.query).get("k", [""])[0]
                    with viewer.sim.lock:
                        desc = keymap.apply_key(viewer.sim, k) or ""
                    self._send(desc.encode(), "text/plain")
                elif url.path == "/field":
                    # mouse-driven interaction field (BASELINE config 2 —
                    # a NEW feature, the reference's field.rs is lighting
                    # only): ctrl-drag in the browser points the
                    # InteractionField at the fluid from the next step
                    q = parse_qs(url.query)
                    with viewer.sim.lock:
                        desc = viewer.apply_field(q)
                    self._send(desc.encode(), "text/plain")
                else:
                    self.send_error(404)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)

    def apply_field(self, q: dict) -> str:
        """Point the InteractionField with the mouse (/field endpoint).

        ``?x=&y=&z=&s=`` positions the field (s>0 repels, s<0 attracts);
        ``?off=1`` disables it. Radius comes from ``?r=``, else the scene's
        own active-field radius, else a view-scaled default. The new field
        applies from the next step."""
        sim = self.sim
        if "off" in q:
            sim.tune(field={"strength": 0.0})
            return "field off"
        p = sim.params
        dim = int(sim.state.pos.shape[1])
        pos = [float(q.get(k, ["0"])[0]) for k in ("x", "y", "z")][:dim]
        s = float(q.get("s", ["20"])[0])
        if "r" in q:
            r = float(q["r"][0])
        elif float(p.field.strength) != 0.0:
            r = float(p.field.radius)
        else:
            h = float(p.smoothing_radius)
            r = max(3.0 * h, 0.12 * float(p.container.half_size.max()))
        sim.tune(field={"position": pos, "strength": s, "radius": r})
        return f"field s={s:+.1f} r={r:.2f} @ ({', '.join(f'{v:.2f}' for v in pos)})"

    def _snapshot(self):
        sim = self.sim
        st = sim.stats()
        # the Simulation's own buffers: tune and reset copy into them
        p, state = sim.params, sim.state
        c = p.container
        t = float(state.time)
        center = (c.center + c.velocity * t).cpu().numpy().astype(np.float32)
        half = c.half_size.cpu().numpy()
        angle = float(c.angle + c.angular_velocity * t)
        hud = (f"step {st['step']}  t={st['time']:.2f}s  "
               f"KE={st['kinetic_energy']:.3g}  "
               f"{st.get('particle_steps_per_s', 0):,.0f} ps/s  "
               f"[{sim.phase.value}]\n" + keymap.params_line(sim)
               + f"\noverflow={int(state.overflow)}")
        payload = {
            "mode": self.render,
            "center": [float(x) for x in center],
            "half": [float(x) for x in half],
            "angle": angle,
            "extent": float(np.max(half)),
            "radius": float(p.particle_radius),
            "hud": hud,
            "dim": int(state.pos.shape[1]),
        }
        fs = float(p.field.strength)
        if fs != 0.0:
            payload["field"] = {
                "p": [float(v) for v in p.field.position.cpu().numpy()],
                "s": fs, "r": float(p.field.radius),
            }
        if self.render == "raster":
            from . import raster

            w, h = self.raster_size
            # container-following bounds so the moving box stays in frame
            lo = torch.from_numpy(center[:2] - half[:2]).to(state.pos.device)
            hi = torch.from_numpy(center[:2] + half[:2]).to(state.pos.device)
            den = raster.raster2d(state.pos, state.density, (lo, hi), w,
                                  h).cpu().numpy()
            speed_v = (state.vel ** 2).sum(dim=1).sqrt()
            spd = raster.raster2d(state.pos, state.density * speed_v,
                                  (lo, hi), w, h).cpu().numpy()
            # normalize on host (tiny arrays): density -> brightness,
            # density-weighted speed -> hue
            dmax = max(float(np.percentile(den, 99.5)), 1e-6)
            du8 = np.clip(den / dmax * 255.0, 0, 255).astype(np.uint8)
            with np.errstate(invalid="ignore", divide="ignore"):
                mean_speed = np.where(den > 0, spd / np.maximum(den, 1e-9),
                                      0.0)
            smax = max(float(np.percentile(mean_speed, 98)), 1e-3)
            su8 = np.clip(mean_speed / smax * 255.0, 0, 255).astype(np.uint8)
            payload.update({
                "rw": w, "rh": h,
                "den": base64.b64encode(du8.tobytes()).decode(),
                "spd": base64.b64encode(su8.tobytes()).decode(),
            })
        else:
            # id-ordered fetch: sorted-state runs permute device rows each
            # step — indexing raw rows would reshuffle the subsample (point
            # identity flicker)
            pos = sim.positions()[self.sel].astype(np.float32)
            vel = sim.velocities()[self.sel]
            speed = np.linalg.norm(vel, axis=1).astype(np.float32)
            payload.update({
                "pos": base64.b64encode(pos.tobytes()).decode(),
                "speed": base64.b64encode(speed.tobytes()).decode(),
                "vmax": float(max(np.percentile(speed, 98), 1e-3)),
            })
        with self.lock:
            self.frame["json"] = json.dumps(payload).encode()

    def serve(self, max_seconds: float | None = None):
        """Run the step/snapshot loop (blocking) with the HTTP server in a
        daemon thread."""
        self.thread.start()
        host, port = self.httpd.server_address[:2]
        print(f"viewer at http://{host}:{port}/  (ctrl-c stops)", flush=True)
        t0 = time.perf_counter()
        try:
            while not self._stop.is_set():
                # a frame's steps and reads under the Simulation's lock;
                # the sleep after it lets a waiting handler take the lock
                # (CPython locks are not fair)
                with self.sim.lock:
                    if self.sim.phase.value != "paused":
                        self.sim.run(self.steps_per_frame)
                    self._snapshot()
                time.sleep(0.002)
                if max_seconds and time.perf_counter() - t0 > max_seconds:
                    break
        except KeyboardInterrupt:
            pass
        finally:
            self.httpd.shutdown()
            self.httpd.server_close()
        return self.sim

    def stop(self):
        self._stop.set()
