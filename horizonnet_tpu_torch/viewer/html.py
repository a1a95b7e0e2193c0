"""Standalone interactive 3D layout viewer as a single HTML file.

Copy of horizonnet_tpu/viewer/html.py: the page it writes is the JAX
package's, byte for byte. The reference's interactive path is an open3d
desktop window (layout_viewer.py:138-169), unusable on headless hosts;
here the interactive artifact is a self-contained HTML file: mesh,
texture colors and corner wireframe embedded as base64 typed arrays, and
an inline WebGL2 renderer with orbit/zoom/pan controls. No external
script, CDN or server: it opens from disk in any browser.

Produced by ``cli.layout_viewer --html out.html`` (and by ``--vis`` when
open3d is absent).
"""

import base64
import json

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>horizonnet_tpu layout</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#111;color:#ccc;
  font:12px system-ui,sans-serif}
 canvas{width:100%;height:100%;display:block}
 #hud{position:fixed;left:8px;top:8px;pointer-events:none;opacity:.8}
</style></head><body>
<div id="hud">drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan
 &nbsp; w: wireframe &nbsp; MESHSTATS</div>
<canvas id="c"></canvas>
<script id="meshdata" type="application/json">DATAJSON</script>
<script>
"use strict";
const D = JSON.parse(document.getElementById("meshdata").textContent);
const b64f32 = s => new Float32Array(
  Uint8Array.from(atob(s), c => c.charCodeAt(0)).buffer);
const b64u32 = s => new Uint32Array(
  Uint8Array.from(atob(s), c => c.charCodeAt(0)).buffer);
const b64u8 = s => Uint8Array.from(atob(s), c => c.charCodeAt(0));
const pos = b64f32(D.pos), col = b64u8(D.col), idx = b64u32(D.idx);
const wpos = D.wpos ? b64f32(D.wpos) : null;
const widx = D.widx ? b64u32(D.widx) : null;

const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl2", {antialias: true});
if (!gl) document.getElementById("hud").textContent =
  "WebGL2 unavailable in this browser";

function shader(type, src) {
  const s = gl.createShader(type);
  gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;
}
const vs = `#version 300 es
layout(location=0) in vec3 p; layout(location=1) in vec3 c;
uniform mat4 mvp; out vec3 vc;
void main(){ gl_Position = mvp * vec4(p, 1.0); vc = c; }`;
const fs = `#version 300 es
precision mediump float; in vec3 vc; uniform vec3 tint; out vec4 o;
void main(){ o = vec4(vc * tint, 1.0); }`;
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, vs));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, fs));
gl.linkProgram(prog);
if (!gl.getProgramParameter(prog, gl.LINK_STATUS))
  throw gl.getProgramInfoLog(prog);
gl.useProgram(prog);
const uMVP = gl.getUniformLocation(prog, "mvp");
const uTint = gl.getUniformLocation(prog, "tint");

function makeVAO(p, c, i) {
  const vao = gl.createVertexArray(); gl.bindVertexArray(vao);
  gl.bindBuffer(gl.ARRAY_BUFFER, gl.createBuffer());
  gl.bufferData(gl.ARRAY_BUFFER, p, gl.STATIC_DRAW);
  gl.enableVertexAttribArray(0);
  gl.vertexAttribPointer(0, 3, gl.FLOAT, false, 0, 0);
  gl.bindBuffer(gl.ARRAY_BUFFER, gl.createBuffer());
  gl.bufferData(gl.ARRAY_BUFFER, c, gl.STATIC_DRAW);
  gl.enableVertexAttribArray(1);
  gl.vertexAttribPointer(1, 3, gl.UNSIGNED_BYTE, true, 0, 0);
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, gl.createBuffer());
  gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, i, gl.STATIC_DRAW);
  gl.bindVertexArray(null);
  return vao;
}
const meshVAO = makeVAO(pos, col, idx);
let wfVAO = null;
if (wpos) {
  const wcol = new Uint8Array(wpos.length); wcol.fill(255);
  wfVAO = makeVAO(wpos, wcol, widx);
}

// Orbit state: camera at the pano origin looking outward works poorly
// for a room; orbit around the room centroid instead.
let yaw = 0.6, pitch = -0.35, dist = D.radius * 2.2;
let panX = 0, panY = 0, showWf = !!wpos;
const ctr = D.center;

function mat(){
  const aspect = canvas.width / canvas.height;
  const f = 1.6, n = 0.05, fa = D.radius * 20;
  const proj = [f/aspect,0,0,0, 0,f,0,0, 0,0,(fa+n)/(n-fa),-1,
                0,0,2*fa*n/(n-fa),0];
  const cy=Math.cos(yaw), sy=Math.sin(yaw),
        cp=Math.cos(pitch), sp=Math.sin(pitch);
  const eye=[ctr[0]+dist*cp*sy+panX, ctr[1]-dist*cp*cy+panY,
             ctr[2]+dist*sp];
  const at=[ctr[0]+panX, ctr[1]+panY, ctr[2]];
  const zx=eye[0]-at[0], zy=eye[1]-at[1], zz=eye[2]-at[2];
  const zl=Math.hypot(zx,zy,zz), z=[zx/zl,zy/zl,zz/zl];
  const up=[0,0,1];
  const x=[up[1]*z[2]-up[2]*z[1], up[2]*z[0]-up[0]*z[2],
           up[0]*z[1]-up[1]*z[0]];
  const xl=Math.hypot(...x); x[0]/=xl; x[1]/=xl; x[2]/=xl;
  const y=[z[1]*x[2]-z[2]*x[1], z[2]*x[0]-z[0]*x[2],
           z[0]*x[1]-z[1]*x[0]];
  const tx=-(x[0]*eye[0]+x[1]*eye[1]+x[2]*eye[2]);
  const ty=-(y[0]*eye[0]+y[1]*eye[1]+y[2]*eye[2]);
  const tz=-(z[0]*eye[0]+z[1]*eye[1]+z[2]*eye[2]);
  const view=[x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
              tx,ty,tz,1];
  // column-major proj * view
  const m = new Float32Array(16);
  for (let r=0;r<4;r++) for (let cI=0;cI<4;cI++){
    let s=0; for(let k=0;k<4;k++) s+=proj[k*4+r]*view[cI*4+k];
    m[cI*4+r]=s;
  }
  return m;
}

function draw(){
  canvas.width = canvas.clientWidth * devicePixelRatio;
  canvas.height = canvas.clientHeight * devicePixelRatio;
  gl.viewport(0, 0, canvas.width, canvas.height);
  gl.enable(gl.DEPTH_TEST);
  gl.clearColor(0.07, 0.07, 0.08, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(uMVP, false, mat());
  gl.uniform3f(uTint, 1, 1, 1);
  gl.bindVertexArray(meshVAO);
  gl.drawElements(gl.TRIANGLES, idx.length, gl.UNSIGNED_INT, 0);
  if (wfVAO && showWf){
    gl.uniform3f(uTint, 1, 0.15, 0.15);
    gl.bindVertexArray(wfVAO);
    gl.drawElements(gl.LINES, widx.length, gl.UNSIGNED_INT, 0);
  }
  gl.bindVertexArray(null);
}

let drag = null;
canvas.addEventListener("pointerdown", e => {
  drag = {x: e.clientX, y: e.clientY, pan: e.shiftKey};
  canvas.setPointerCapture(e.pointerId);
});
canvas.addEventListener("pointermove", e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan){ panX -= dx * dist * 0.002; panY += dy * dist * 0.002; }
  else {
    yaw += dx * 0.008;
    pitch = Math.min(1.5, Math.max(-1.5, pitch - dy * 0.008));
  }
  requestAnimationFrame(draw);
});
canvas.addEventListener("pointerup", () => drag = null);
canvas.addEventListener("wheel", e => {
  e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.001);
  requestAnimationFrame(draw);
}, {passive: false});
addEventListener("keydown", e => {
  if (e.key === "w"){ showWf = !showWf; requestAnimationFrame(draw); }
});
addEventListener("resize", () => requestAnimationFrame(draw));
draw();
</script></body></html>
"""


def _b64(a):
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


def write_html_viewer(path, xyz, rgb, faces, wireframe=None):
    """Write the self-contained viewer.

    xyz: [N, 3] float vertices; rgb: [N, 3] colors (0..1 float or 0..255);
    faces: [F, 3] int triangle indices; wireframe: optional (pts [M, 3],
    lines [L, 2]) from viewer.mesh.corner_wireframe. Vertices not used by
    any face are dropped before embedding. To bound the file size, pass a
    mesh built from a strided pixel grid (cli.layout_viewer decimates the
    grid 2x before triangulating — holes-free, unlike dropping faces).
    """
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        scale = 255.0 if rgb.max() <= 1.0 + 1e-6 else 1.0
        rgb = np.clip(rgb * scale, 0, 255).astype(np.uint8)
    rgb = rgb.reshape(-1, 3)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)

    used = np.unique(faces)
    remap = np.full(len(xyz), -1, np.int64)
    remap[used] = np.arange(len(used))
    v = xyz[used]
    c = rgb[used]
    f = remap[faces].astype(np.uint32)

    if len(v):
        lo, hi = v.min(0), v.max(0)
    elif wireframe is not None and len(wireframe[0]):
        # Wireframe-only viewer (e.g. --ignore_floor/_ceiling/_wall):
        # frame the camera on the corner wireframe instead of crashing
        # on a zero-size reduction.
        wpts = np.asarray(wireframe[0], np.float32)
        lo, hi = wpts.min(0), wpts.max(0)
    else:
        lo = hi = np.zeros(3, np.float32)
    center = ((lo + hi) / 2).tolist()
    radius = float(np.linalg.norm(hi - lo) / 2) or 1.0

    data = {"pos": _b64(v), "col": _b64(c), "idx": _b64(f),
            "center": center, "radius": radius,
            "n_vertices": int(len(v)), "n_faces": int(len(f))}
    if wireframe is not None:
        pts, lines = wireframe[0], wireframe[1]
        data["wpos"] = _b64(np.asarray(pts, np.float32))
        data["widx"] = _b64(np.asarray(lines, np.uint32))

    page = _PAGE.replace("DATAJSON", json.dumps(data))
    page = page.replace("MESHSTATS",
                        f"{len(v):,} verts / {len(f):,} tris")
    with open(path, "w") as fh:
        fh.write(page)
    return len(v), len(f)
