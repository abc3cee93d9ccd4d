"""Live 3D trajectory viewer — the headless-native replacement for the
reference's Pangolin / raw-GL X11 scene window (a copy of
``msckf_stereo_c_tpu/io/live_viewer.py``, which is numpy and the standard
library only; the port keeps its own copy rather than import it).

The reference renders the estimated path + initialized landmarks live in an
orbit-camera GL window (apps/run_euroc_single_thread.cpp:131-148,256-322;
glwindow/scenewindow.cpp:46-175: azimuth/elevation/distance viewpoint,
mouse-drag rotation, wheel zoom).  An accelerator host is headless — no X11 —
so the live view is served over HTTP instead: a zero-dependency stdlib
server streams the pose path and landmark cloud as JSON while an embedded
single-file canvas renderer reproduces the scenewindow interaction model
(drag = orbit azimuth/elevation, wheel = dolly, grid floor, frustum marker
at the latest pose).  Point a browser at http://localhost:<port>/ during a
run (``python -m msckf_stereo_c_torch.apps.run_euroc --viewer``).

No sockets are opened unless ``start()`` is called; ``publish()`` is a
lock-guarded in-memory swap, so the VIO loop never blocks on a client.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>msckf_stereo_c_torch live</title>
<style>
 body{margin:0;background:#101014;color:#cfd2d6;font:12px monospace;overflow:hidden}
 #hud{position:fixed;left:8px;top:8px;white-space:pre}
 canvas{display:block}
</style></head><body>
<div id="hud"></div><canvas id="c"></canvas>
<script>
// Orbit camera state (scenewindow.cpp:101-175 semantics: drag rotates
// azimuth/elevation, wheel changes distance).
let az=0.9, el=0.5, dist=18, cx=0, cy=0, cz=0;
let path=[], points=[], seq=-1, frame=0;
const cv=document.getElementById('c'), ctx=cv.getContext('2d');
function resize(){cv.width=innerWidth;cv.height=innerHeight;}
addEventListener('resize',resize);resize();
let drag=null;
cv.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY]);
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
  az-=(e.clientX-drag[0])*0.008; el+=(e.clientY-drag[1])*0.008;
  el=Math.max(-1.55,Math.min(1.55,el)); drag=[e.clientX,e.clientY];});
cv.addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();});
function proj(p){
  const ca=Math.cos(az),sa=Math.sin(az),ce=Math.cos(el),se=Math.sin(el);
  let x=p[0]-cx,y=p[1]-cy,z=p[2]-cz;
  let x1=ca*x+sa*y, y1=-sa*x+ca*y;          // azimuth about +z
  let y2=ce*y1+se*z, z2=-se*y1+ce*z;        // elevation
  let d=dist+y2;                             // camera looks along +y2
  if(d<0.2) return null;
  const f=0.9*Math.min(cv.width,cv.height);
  return [cv.width/2+f*x1/d, cv.height/2-f*z2/d];
}
function line(a,b,st){const pa=proj(a),pb=proj(b);if(!pa||!pb)return;
  ctx.strokeStyle=st;ctx.beginPath();ctx.moveTo(pa[0],pa[1]);ctx.lineTo(pb[0],pb[1]);ctx.stroke();}
function draw(){
  ctx.fillStyle='#101014';ctx.fillRect(0,0,cv.width,cv.height);
  ctx.lineWidth=1;
  for(let i=-10;i<=10;i+=2){  // grid floor
    line([i,-10,0],[i,10,0],'#23232c'); line([-10,i,0],[10,i,0],'#23232c');}
  line([0,0,0],[1.5,0,0],'#a33'); line([0,0,0],[0,1.5,0],'#3a3'); line([0,0,0],[0,0,1.5],'#36a');
  ctx.fillStyle='#8fa3bf';
  for(const p of points){const q=proj(p);if(q)ctx.fillRect(q[0],q[1],2,2);}
  ctx.lineWidth=1.6;
  for(let i=1;i<path.length;i++) line(path[i-1],path[i],'#56c15c');
  if(path.length){const q=proj(path[path.length-1]);
    if(q){ctx.fillStyle='#ffd24d';ctx.beginPath();ctx.arc(q[0],q[1],4,0,7);ctx.fill();}}
  document.getElementById('hud').textContent=
    `frame ${frame}  path ${path.length}  landmarks ${points.length}\\n`+
    `drag: orbit   wheel: zoom`;
  requestAnimationFrame(draw);
}
async function poll(){
  try{
    const r=await fetch('/state.json?seq='+seq);
    if(r.ok){const s=await r.json();
      if(s.seq!==seq){path=s.path;points=s.points;seq=s.seq;frame=s.frame;
        if(path.length){cx=path[path.length-1][0];cy=path[path.length-1][1];cz=0;}}}
  }catch(e){}
  setTimeout(poll,250);
}
poll();draw();
</script></body></html>"""


class LiveViewer:
    """Serve the live scene; swap-in new state with ``publish``."""

    def __init__(self, port: int = 8642, max_path: int = 100000):
        self.port = port
        self.max_path = max_path
        self._lock = threading.Lock()
        self._path: list = []
        self._points = np.zeros((0, 3))
        self._seq = 0
        self._frame = 0
        self._state_cache: Optional[tuple] = None  # (seq, serialized bytes)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- producer side ----------------------------------------------------
    def publish(self, positions: np.ndarray, points: Optional[np.ndarray] = None, frame: Optional[int] = None):
        """Append pose positions (N,3) and replace the landmark cloud."""
        positions = np.asarray(positions, dtype=float).reshape(-1, 3)
        with self._lock:
            self._path.extend(positions.tolist())
            if len(self._path) > self.max_path:
                self._path = self._path[-self.max_path :]
            if points is not None:
                self._points = np.asarray(points, dtype=float).reshape(-1, 3)
            if frame is not None:
                self._frame = int(frame)
            else:
                self._frame += len(positions)
            self._seq += 1

    def state_json(self) -> bytes:
        # Snapshot under the lock; serialize OUTSIDE it (a 100k-point path is
        # multi-MB of JSON — holding the lock through json.dumps would block
        # publish(), i.e. the VIO loop, for the serialization duration).
        # The serialized bytes are cached per seq so concurrent pollers cost
        # one dumps per published update, not one per request.
        with self._lock:
            if self._state_cache is not None and self._state_cache[0] == self._seq:
                return self._state_cache[1]
            seq, frame = self._seq, self._frame
            path = list(self._path)
            points = self._points
        body = json.dumps(
            {"seq": seq, "frame": frame, "path": path, "points": points.tolist()}
        ).encode()
        with self._lock:
            if self._state_cache is None or seq >= self._state_cache[0]:
                self._state_cache = (seq, body)
        return body

    # -- server side -------------------------------------------------------
    def start(self) -> int:
        """Start serving; returns the bound port (0 picks an ephemeral one)."""
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?")[0] == "/state.json":
                    body = viewer.state_json()
                    ctype = "application/json"
                elif self.path == "/":
                    body = _PAGE.encode()
                    ctype = "text/html; charset=utf-8"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
