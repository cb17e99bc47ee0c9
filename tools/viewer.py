#!/usr/bin/env python
"""Interactive progressive render viewer — the analog of the reference's
in-browser WASM frontend (examples/web/src/lib.rs: `Scene::new` +
`render_block` + `get_img` progressive path tracing driven from JS).

The reference compiles the renderer to WASM so the browser is the compute
device; here the compute device is the accelerator, so the browser is a thin
interactive frontend over HTTP while the wavefront renderer accumulates
passes server-side:

  * progressive accumulation: one whole-wavefront pass per step (the
    reference's `render_block` unit becomes one full-image sample — there
    are no blocks on a wavefront machine), running average like lib.rs's
    `img[i] += c; nb_samples[i] += 1`.
  * interactivity: click-drag orbit / wheel zoom / key controls move the
    camera around the scene's bounding-sphere center and restart
    accumulation.  The interactive step jits with the CAMERA AS AN
    ARGUMENT (geometry/material/emitter tables stay compile-time
    constants), so every camera move reuses ONE executable instead of
    recompiling — the property that makes orbiting viable when a cold
    compile takes minutes.
  * `get_img` analog: gamma-2.2 tonemapped PNG (lib.rs:221-232), polled by
    the page's fetch loop.

  python tools/viewer.py cbox --port 8000 -- path -m 6
"""
import argparse
import io
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np

_STATE = {
    "png": b"", "spp": 0, "elapsed": 0.0, "seq": 0, "paused": False,
    "backend": "", "width": 0, "height": 0, "pass_s": 0.0, "scene": "",
    "integrator": "", "stop": False,
}
_LOCK = threading.Lock()
_ORBIT = {"dirty": False, "theta": 0.0, "phi": 0.0, "radius": 1.0,
          "target": None, "up": np.array([0.0, 1.0, 0.0], np.float32)}

#: client-side tracer state: scene JSON (or an export error) + JS source path
_WEB = {"scene_json": None, "error": None}
_TRACER_JS = Path(__file__).parent / "web_tracer.js"


class WebExportError(RuntimeError):
    pass


def scene_to_web_json(scene, integrator=None, seed=0):
    """Flatten a host Scene into the JSON the in-browser tracer consumes.

    Data-only export (triangle soup + two-slot material table + flux-CDF
    emitter atoms + camera matrices) — the client reimplements ALL
    transport independently (tools/web_tracer.js). Round-5 scope (VERDICT
    r4 item 8): constant-color diffuse / phong / glass / metal
    (smooth+rough Beckmann/GGX) / rough substrate / blend-of-atomics
    materials; triangle area + point + directional + constant-environment
    lights; no medium, no textures, no textured env. Anything else raises
    WebExportError so /api/scene.json can answer 501 loudly instead of
    silently rendering the wrong image.

    Materials export mirrors the renderer's own two-slot blend design
    (bsdfs/table.py): every triangle carries slot A and slot B atomic
    parameters plus blend_w; non-blend materials point both slots at
    themselves with weight 1, so the client has ONE mixture code path.
    The diffuse slot's texture (constant / checker / grid / bitmap,
    BSDFColor mod.rs:11-121) exports too, with per-corner uvs and the
    scene atlas (bounded: big atlases are beyond JSON-export scope).
    """
    if scene.volume is not None:
        raise WebExportError("client tracer: no participating media")
    if scene.env_image is not None \
            and np.asarray(scene.env_image).size > 256 * 256 * 3:
        raise WebExportError(
            "client tracer: environment map too large for JSON export")
    if scene.point_normal_lights:
        raise WebExportError("client tracer: no point-normal emitters")
    mats = scene.materials or []

    def atomic_slot(mat):
        """Validate + flatten one atomic (non-blend) material."""
        k = int(mat.kind)
        if k not in (0, 1, 2, 3, 4):
            raise WebExportError(
                "client tracer: diffuse/phong/glass/metal/substrate/blend "
                f"materials only (kind {k})")
        tk = int(getattr(mat, "tex_kind", 0))
        if tk not in (0, 1, 2, 3):
            raise WebExportError(f"client tracer: unknown tex_kind {tk}")
        if tk == 1 and not (scene.textures is not None
                            and 0 <= int(mat.tex_img)
                            < len(scene.textures)):
            raise WebExportError("client tracer: bitmap texture without "
                                 "a scene atlas slot")
        if k == 4 and float(mat.alpha) <= 0.0:
            raise WebExportError(
                "client tracer: smooth substrate (DELTA|DIFFUSE) "
                "out of scope")
        return {
            "kind": k,
            "kd": np.asarray(mat.kd, np.float64),
            "ks": np.asarray(mat.ks, np.float64),
            "eta_c": np.asarray(mat.eta_c, np.float64),
            "k_c": np.asarray(mat.k_c, np.float64),
            "alpha": float(mat.alpha),
            "ggx": bool(mat.dist_ggx),
            "exponent": float(mat.exponent),
            "wspec": float(mat.weight_specular),
            "tex_kind": tk,
            "tex_c1": np.asarray(getattr(mat, "tex_c1", (0, 0, 0)),
                                 np.float64),
            "tex_scale": np.asarray(getattr(mat, "tex_scale", (1, 1)),
                                    np.float64),
            "tex_offset": np.asarray(getattr(mat, "tex_offset", (0, 0)),
                                     np.float64),
            "tex_lw": float(getattr(mat, "tex_lw", 0.1)),
            "tex_img": int(getattr(mat, "tex_img", -1)),
        }

    SLOT_COLS = ("kind", "kd", "ks", "eta_c", "k_c", "alpha", "ggx",
                 "exponent", "wspec", "tex_kind", "tex_c1", "tex_scale",
                 "tex_offset", "tex_lw", "tex_img")
    v0, e1, e2, le, kt, eta, blend_w, vuv = [], [], [], [], [], [], [], []
    slot_a = {c: [] for c in SLOT_COLS}
    slot_b = {c: [] for c in SLOT_COLS}
    em_tri, em_weight = [], []
    pts = []
    for mesh in scene.meshes:
        mat = mats[mesh.material]
        if int(mat.kind) == 5:                       # blend
            ma = mats[mat.sub_a]
            mb = mats[mat.sub_b]
            if int(ma.kind) in (2, 5) or int(mb.kind) in (2, 5):
                raise WebExportError(
                    "client tracer: blend subs must be atomic non-glass")
            sa, sb = atomic_slot(ma), atomic_slot(mb)
            bw = float(mat.blend_w)
        else:
            sa = sb = atomic_slot(mat)
            bw = 1.0
        if mesh.emission_kind != 0:
            raise WebExportError("client tracer: constant emission only")
        verts = np.asarray(mesh.vertices, np.float64)
        areas = mesh.triangle_areas().astype(np.float64)
        flux_scalar = float(np.max(mesh.flux()))
        total = max(float(areas.sum()), 1e-30)
        pts.append(verts)
        uvs = (np.asarray(mesh.uvs, np.float64)
               if mesh.uvs is not None else None)
        for k, (i0, i1, i2) in enumerate(np.asarray(mesh.indices)):
            t = len(v0)
            v0.append(verts[i0])
            e1.append(verts[i1] - verts[i0])
            e2.append(verts[i2] - verts[i0])
            vuv.append(np.stack([uvs[i0], uvs[i1], uvs[i2]])
                       if uvs is not None else np.zeros((3, 2)))
            for c in SLOT_COLS:
                slot_a[c].append(sa[c])
                slot_b[c].append(sb[c])
            kt.append(np.asarray(mat.kt, np.float64))
            eta.append(float(mat.eta))
            blend_w.append(bw)
            le.append(np.asarray(mesh.emission, np.float64))
            if mesh.is_light:
                em_tri.append(t)
                em_weight.append(flux_scalar * areas[k] / total)
    if len(v0) > 100_000:
        raise WebExportError(
            "client tracer is the NaiveAcceleration analog: "
            f"{len(v0)} triangles is beyond brute-force scope")

    # scene bounding-sphere radius: the directional/env flux scale
    # (scene.rs:53-123)
    if pts:
        allp = np.concatenate(pts)
        ctr = 0.5 * (allp.min(0) + allp.max(0))
        bs_radius = float(np.linalg.norm(allp - ctr, axis=-1).max())
    else:
        bs_radius = 1.0

    # emitter atoms: tri (flux x area frac), point (4pi I), directional
    # (pi r^2 I), constant env (pi r^2 max) — the flux-CDF design of
    # scene/emitters.py:150-185
    atoms, w = [], []
    for i, t in enumerate(em_tri):
        atoms.append({"k": 0, "ref": int(t)})
        w.append(em_weight[i])
    points, dirs = [], []
    for pos, inten in scene.point_lights:
        atoms.append({"k": 1, "ref": len(points)})
        points.append([np.asarray(pos, np.float64).tolist(),
                       np.asarray(inten, np.float64).tolist()])
        w.append(float(np.max(np.asarray(inten) * 4.0 * np.pi)))
    for dvec, inten in scene.directional_lights:
        dn = np.asarray(dvec, np.float64)
        dn = dn / np.linalg.norm(dn)
        atoms.append({"k": 2, "ref": len(dirs)})
        dirs.append([dn.tolist(), np.asarray(inten, np.float64).tolist()])
        w.append(float(np.max(np.asarray(inten)))
                 * np.pi * (bs_radius * 1.1) ** 2)
    env_color = None
    env_img = None
    if scene.env_image is not None:
        env_img = np.asarray(scene.env_image, np.float64)
        h_e = env_img.shape[0]
        sin_w = np.sin((np.arange(h_e) + 0.5) * np.pi / h_e)[:, None]
        lum = env_img @ np.asarray([0.212671, 0.715160, 0.072169])
        atoms.append({"k": 3, "ref": 0})
        w.append(np.pi * (bs_radius * 1.1) ** 2
                 * float((lum * sin_w).mean()))
        env_img = env_img.tolist()
    elif scene.env_constant is not None:
        env_color = np.asarray(scene.env_constant, np.float64).tolist()
        atoms.append({"k": 3, "ref": 0})
        w.append(float(np.max(scene.env_constant))
                 * np.pi * (bs_radius * 1.1) ** 2)
    if not atoms or sum(w) <= 0.0:
        raise WebExportError("client tracer: no emitters")
    w = np.asarray(w, np.float64)

    def slot_json(sl):
        return {
            "kind": [int(x) for x in sl["kind"]],
            "kd": np.asarray(sl["kd"]).tolist(),
            "ks": np.asarray(sl["ks"]).tolist(),
            "eta_c": np.asarray(sl["eta_c"]).tolist(),
            "k_c": np.asarray(sl["k_c"]).tolist(),
            "alpha": [float(x) for x in sl["alpha"]],
            "ggx": [bool(x) for x in sl["ggx"]],
            "exponent": [float(x) for x in sl["exponent"]],
            "wspec": [float(x) for x in sl["wspec"]],
            "tex_kind": [int(x) for x in sl["tex_kind"]],
            "tex_c1": np.asarray(sl["tex_c1"]).tolist(),
            "tex_scale": np.asarray(sl["tex_scale"]).tolist(),
            "tex_offset": np.asarray(sl["tex_offset"]).tolist(),
            "tex_lw": [float(x) for x in sl["tex_lw"]],
            "tex_img": [int(x) for x in sl["tex_img"]],
        }

    any_tex = any(tk != 0
                  for tk in slot_a["tex_kind"] + slot_b["tex_kind"])
    textures = None
    if scene.textures is not None and any(
            tk == 1 for tk in slot_a["tex_kind"] + slot_b["tex_kind"]):
        atlas = np.asarray(scene.textures, np.float64)
        if atlas.size > 4 * 256 * 256 * 3:
            raise WebExportError(
                "client tracer: texture atlas too large for JSON export")
        textures = atlas.tolist()

    cam = scene.camera
    return {
        "v0": np.asarray(v0).tolist(), "e1": np.asarray(e1).tolist(),
        "e2": np.asarray(e2).tolist(),
        "a": slot_json(slot_a), "b": slot_json(slot_b),
        "blend_w": blend_w,
        "vuv": np.asarray(vuv).tolist() if any_tex else None,
        "textures": textures,
        "kt": np.asarray(kt).tolist(), "eta": eta,
        "le": np.asarray(le).tolist(),
        "atoms": atoms, "atom_prob": (w / w.sum()).tolist(),
        "em_tri": em_tri,
        "points": points, "dirs": dirs, "env_color": env_color,
        "env_img": env_img,
        "cam": {
            "s2c": np.asarray(cam.sample_to_camera, np.float64).tolist(),
            "to_world": np.asarray(cam.to_world, np.float64).tolist(),
            "width": int(cam.width), "height": int(cam.height),
        },
        "max_depth": getattr(integrator, "max_depth", 5) if integrator
        else 5,
        "min_depth": getattr(integrator, "min_depth", 0) if integrator
        else 0,
        "seed": int(seed),
    }


_LOCAL_PAGE = """<!doctype html><html><head>
<title>rustlight_tpu local tracer</title>
<style>
 body{background:#1b1b1f;color:#d6d6dc;font-family:monospace;margin:0}
 #bar{padding:8px 12px;display:flex;gap:16px;align-items:center}
 #bar b{color:#8ecaff}
 canvas{image-rendering:pixelated;width:70vmin;display:block;margin:0 auto}
 button{background:#2a2a31;color:#d6d6dc;border:1px solid #444;
        font-family:monospace;padding:2px 10px;cursor:pointer}
 #help{padding:4px 12px;color:#888}
</style></head><body>
<div id="bar">
 <b>rustlight_tpu · in-browser</b><span id="stats">loading scene…</span>
 <button id="pause">pause</button>
</div>
<div id="help">compute runs IN THIS TAB (the WASM-frontend analog:
one sample/pixel per pass over 16x16 blocks, brute-force intersection)</div>
<canvas id="cv"></canvas>
<script src="/web_tracer.js"></script>
<script>
const stats=document.getElementById('stats');
let paused=false, tracer=null, ctx=null, pass=0, blocks=[], bi=0, t0=0;
document.getElementById('pause').onclick=()=>{
  paused=!paused;
  document.getElementById('pause').textContent=paused?'resume':'pause';
};
async function boot(){
  const r=await fetch('/api/scene.json');
  if(!r.ok){stats.textContent='scene export: '+await r.text();return;}
  const desc=await r.json();
  tracer=new WebScene(desc);
  const cv=document.getElementById('cv');
  cv.width=tracer.width; cv.height=tracer.height;
  ctx=cv.getContext('2d');
  for(let y=0;y<tracer.height;y+=16)
    for(let x=0;x<tracer.width;x+=16) blocks.push([x,y]);
  t0=performance.now();
  window.__tracer={
    ready:true,
    runSync:(n)=>{for(let p=0;p<n;p++){
      for(const [x,y] of blocks) tracer.renderBlock(x,y,16,16,pass);
      pass++;}tracer.getImg(ctx);},
    mean:()=>Array.from(tracer.meanLinear()),
    varOfMean:()=>Array.from(tracer.varOfMean()),
    spp:()=>tracer.spp(), size:()=>[tracer.width,tracer.height],
  };
  tick();
}
function tick(){
  if(tracer&&!paused){
    const tb=performance.now();
    while(performance.now()-tb<30){
      const [x,y]=blocks[bi];
      tracer.renderBlock(x,y,16,16,pass);
      if(++bi>=blocks.length){bi=0;pass++;}
    }
    tracer.getImg(ctx);
    const el=(performance.now()-t0)/1000;
    stats.textContent=`${tracer.width}x${tracer.height} · ${tracer.spp()} spp`
      +` · ${el.toFixed(1)}s · ${(tracer.spp()/Math.max(el,1e-3)).toFixed(2)}`
      +' pass/s · js-local';
  }
  setTimeout(tick,0);
}
boot();
</script></body></html>"""

_PAGE = """<!doctype html><html><head><title>rustlight_tpu viewer</title>
<style>
 body{background:#1b1b1f;color:#d6d6dc;font-family:monospace;margin:0}
 #bar{padding:8px 12px;display:flex;gap:16px;align-items:center}
 #bar b{color:#8ecaff}
 #img{image-rendering:pixelated;width:70vmin;display:block;margin:0 auto;
      cursor:grab;user-select:none;-webkit-user-drag:none}
 button{background:#2a2a31;color:#d6d6dc;border:1px solid #444;
        font-family:monospace;padding:2px 10px;cursor:pointer}
 #help{padding:4px 12px;color:#888}
</style></head><body>
<div id="bar">
 <b>rustlight_tpu</b><span id="stats">…</span>
 <button id="pause">pause</button><button id="reset">reset</button>
 <a href="/local" style="color:#8ecaff">in-browser tracer</a>
</div>
<div id="help">drag = orbit &nbsp; wheel / +- = zoom &nbsp; arrows = orbit</div>
<img id="img" draggable="false"/>
<script>
const img=document.getElementById('img'), stats=document.getElementById('stats');
let seq=-1, paused=false;
async function post(u,b){await fetch(u,{method:'POST',body:JSON.stringify(b||{})});}
async function poll(){
  try{
    const s=await (await fetch('/api/state')).json();
    stats.textContent=`${s.scene} · ${s.integrator} · ${s.width}x${s.height} · `+
      `${s.spp} spp · ${s.elapsed.toFixed(1)}s · ${s.pass_s.toFixed(1)} pass/s · ${s.backend}`;
    paused=s.paused;
    document.getElementById('pause').textContent=paused?'resume':'pause';
    if(s.seq!==seq){seq=s.seq;img.src='/img.png?v='+seq;}
  }catch(e){}
  setTimeout(poll,250);
}
poll();
let drag=null;
img.addEventListener('pointerdown',e=>{drag=[e.clientX,e.clientY];img.setPointerCapture(e.pointerId);});
img.addEventListener('pointermove',e=>{
  if(!drag)return;
  const dx=e.clientX-drag[0],dy=e.clientY-drag[1];drag=[e.clientX,e.clientY];
  post('/api/orbit',{dtheta:-dx*0.01,dphi:dy*0.01});
});
img.addEventListener('pointerup',e=>{drag=null;});
img.addEventListener('wheel',e=>{e.preventDefault();post('/api/orbit',{dzoom:e.deltaY>0?1.12:0.89});});
document.getElementById('pause').onclick=()=>post('/api/pause',{paused:!paused});
document.getElementById('reset').onclick=()=>post('/api/reset');
window.addEventListener('keydown',e=>{
  const k=e.key;
  if(k==='ArrowLeft')post('/api/orbit',{dtheta:0.15});
  else if(k==='ArrowRight')post('/api/orbit',{dtheta:-0.15});
  else if(k==='ArrowUp')post('/api/orbit',{dphi:0.15});
  else if(k==='ArrowDown')post('/api/orbit',{dphi:-0.15});
  else if(k==='+'||k==='=')post('/api/orbit',{dzoom:0.89});
  else if(k==='-')post('/api/orbit',{dzoom:1.12});
});
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.startswith("/img.png"):
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(_STATE["png"])
        elif self.path.startswith("/api/state"):
            with _LOCK:
                st = {k: v for k, v in _STATE.items() if k != "png"}
            self._json(st)
        elif self.path.startswith("/api/scene.json"):
            if _WEB["scene_json"] is None:
                self.send_response(501)
                self.send_header("Content-Type", "text/plain")
                self.end_headers()
                self.wfile.write(
                    (_WEB["error"] or "no scene exported").encode())
            else:
                self._json(_WEB["scene_json"])
        elif self.path.startswith("/web_tracer.js"):
            self.send_response(200)
            self.send_header("Content-Type", "application/javascript")
            self.end_headers()
            self.wfile.write(_TRACER_JS.read_bytes())
        elif self.path.startswith("/local"):
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(_LOCAL_PAGE.encode())
        else:
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(_PAGE.encode())

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        try:
            body = json.loads(self.rfile.read(n) or b"{}")
        except ValueError:
            body = {}
        with _LOCK:
            if self.path.startswith("/api/orbit"):
                _ORBIT["theta"] += float(body.get("dtheta", 0.0))
                _ORBIT["phi"] = float(np.clip(
                    _ORBIT["phi"] + float(body.get("dphi", 0.0)), -1.48, 1.48))
                _ORBIT["radius"] *= float(body.get("dzoom", 1.0))
                _ORBIT["dirty"] = True
            elif self.path.startswith("/api/pause"):
                _STATE["paused"] = bool(body.get("paused",
                                                 not _STATE["paused"]))
            elif self.path.startswith("/api/reset"):
                _ORBIT["dirty"] = True
        self._json({"ok": True})

    def log_message(self, *a):
        pass


def _orbit_camera(cam):
    """Rebuild the rigid camera transform from the orbit state; the
    projection half (sample<->camera) is untouched, so only to_world /
    to_local change — both traced arguments of the interactive step."""
    from rustlight_tpu.scene.camera import look_at
    t, p, r = _ORBIT["theta"], _ORBIT["phi"], _ORBIT["radius"]
    tgt = _ORBIT["target"]
    eye = tgt + r * np.array([np.cos(p) * np.sin(t), np.sin(p),
                              np.cos(p) * np.cos(t)], np.float32)
    m = look_at(eye, tgt, _ORBIT["up"])
    import jax
    # device_put: the compiled step's executable cache keys on committed
    # shardings, so numpy leaves here (vs the committed device arrays the
    # initial camera carries from Scene.compile) would silently build a
    # second executable per pose family
    return jax.device_put(cam.replace(
        to_world=np.asarray(m, np.float32),
        to_local=np.linalg.inv(m).astype(np.float32)))


def make_interactive_step(sd, integrator):
    """One progressive pass with the camera as a traced argument.

    Returns (step, cam0): `step(cam, pass_idx)` -> [h*w, 3] radiance of one
    sample per pixel, jitted once and reused for every camera pose (the
    reference's `render_block` loop equivalent; geometry stays a
    compile-time constant exactly like the non-interactive path)."""
    import jax
    import jax.numpy as jnp
    from rustlight_tpu.integrators.common import _pixel_grid
    from rustlight_tpu.utils.rng import make_stream, stream_fold

    cam0 = sd.camera
    pix = jnp.asarray(_pixel_grid(cam0.width, cam0.height))
    if hasattr(integrator, "prepare"):
        integrator.prepare(sd)
    base = make_stream(0)

    @jax.jit
    def step(cam, pass_idx):
        sd2 = sd.replace(camera=cam)
        stream = stream_fold(base, pass_idx)
        li = integrator.compute_pixel(sd2, pix, stream)
        ok = jnp.all(jnp.isfinite(li), axis=-1) & jnp.all(li >= 0.0, axis=-1)
        return jnp.where(ok[:, None], li, 0.0)

    return step, cam0


def _render_loop(sd, integrator):
    import jax
    from PIL import Image
    from rustlight_tpu.utils.image import tonemap_gamma

    step, cam = make_interactive_step(sd, integrator)
    h, w = cam.height, cam.width
    with _LOCK:
        _STATE.update(width=w, height=h, backend=jax.default_backend())
    avg = np.zeros((h, w, 3), np.float64)
    it = 0
    t0 = time.time()
    tp = None
    while not _STATE["stop"]:
        with _LOCK:
            if _ORBIT["dirty"]:
                cam = _orbit_camera(cam)
                avg[:] = 0.0
                it = 0
                t0 = time.time()
                _ORBIT["dirty"] = False
            paused = _STATE["paused"]
        if paused:
            time.sleep(0.1)
            continue
        tq = time.time()
        li = np.asarray(step(cam, it)).reshape(h, w, 3)
        avg = (avg * it + li) / (it + 1)
        it += 1
        dt = time.time() - tq
        tp = dt if tp is None else 0.8 * tp + 0.2 * dt
        buf = io.BytesIO()
        Image.fromarray(tonemap_gamma(avg)).save(buf, format="PNG")
        with _LOCK:
            _STATE.update(png=buf.getvalue(), spp=it,
                          elapsed=time.time() - t0, seq=_STATE["seq"] + 1,
                          pass_s=(1.0 / tp if tp > 0 else 0.0),
                          # executables built so far: must stay 1 across
                          # orbits (camera is a traced ARGUMENT, so a pose
                          # change never recompiles)
                          n_exec=step._cache_size())


def main(argv=None, block=True):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scene")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--res", type=float, default=0.25, help="image scale")
    argv = sys.argv[1:] if argv is None else list(argv)
    # everything after a literal `--` goes verbatim to the CLI parser
    # (argparse.REMAINDER would also swallow --port/--res)
    rest_args = []
    if "--" in argv:
        i = argv.index("--")
        argv, rest_args = argv[:i], argv[i + 1:]
    args = ap.parse_args(argv)
    args.rest = rest_args

    from rustlight_tpu.cli import (build_parser, load_scene_arg,
                                   build_integrator)
    from rustlight_tpu.scene.geometry import scene_bounds

    rest = args.rest or ["path"]
    cli_args = build_parser().parse_args(
        [args.scene, "-s", str(args.res)] + rest)
    scene = load_scene_arg(cli_args)
    _, _, center, _ = scene_bounds(scene.meshes)
    sd = scene.compile()
    integ = build_integrator(cli_args)

    # seed the orbit from the loaded camera: spherical coords of the eye
    # around the scene bounding-sphere center
    eye = np.asarray(sd.camera.to_world)[:3, 3]
    v = eye - center
    r = float(np.linalg.norm(v))
    _ORBIT.update(target=center.astype(np.float32), radius=max(r, 1e-3),
                  theta=float(np.arctan2(v[0], v[2])),
                  phi=float(np.arcsin(np.clip(v[1] / max(r, 1e-3), -1, 1))))
    with _LOCK:
        _STATE.update(scene=args.scene, integrator=rest[0])

    # export the scene for the in-browser tracer (/local); scenes outside
    # the client scope serve a 501 with the reason instead of failing here
    try:
        _WEB["scene_json"] = scene_to_web_json(scene, integ)
        _WEB["error"] = None
    except WebExportError as e:
        _WEB["scene_json"], _WEB["error"] = None, str(e)

    server = ThreadingHTTPServer(("0.0.0.0", args.port), _Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"serving on http://localhost:{args.port}", flush=True)

    if block:
        _render_loop(sd, integ)
    else:
        threading.Thread(target=_render_loop, args=(sd, integ),
                         daemon=True).start()
        return server


if __name__ == "__main__":
    main()
