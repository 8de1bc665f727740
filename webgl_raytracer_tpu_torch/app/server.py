"""Interactive web viewer: the serving layer, in one process on the card.

Counterpart of webgl_raytracer_tpu/app/server.py, with the same routes
and the same JSON answers:

  GET  /            the viewer page (drag to orbit, WASDQE to fly, number
                    keys for vis modes)
  GET  /frame.png   advances one progressive frame if below max_frames and
                    returns the current tone-mapped image at the base size
  GET  /state       render/camera state as JSON (host state only)
  GET  /envs        the HDR manifest and the current environment
  GET  /hover?x=&y= hover pick: primitive label + projected AABB rect
  POST /orbit       {"dx", "dy", "start"} orbit drag with the first-drag
                    axis lock (resets accumulation)
  POST /fly         {"keys": ["w", ...], "dt": seconds}
  POST /settings    partial RenderSettings update (resets accumulation)
  POST /light       {"index", ...} one light's fields
  POST /sky         partial analytic-sky update; regenerates the env
  POST /env         {"mode": "off"|"sky"|"hdr", "file": manifest name}
  POST /load        {"scene", "style", "surface", "volume", ...} switches
                    the scene in-session
  POST /focus       {"x", "y"} click-to-focus (sets dof_focus_distance)

The stdlib ThreadingHTTPServer answers each request on its own thread.
Every touch of the Renderer, and so of a device tensor, happens under
ViewerState.lock: the first frame after a change of size, scene or
environment captures a CUDA graph on whichever thread holds the lock, and
a capture fails if another thread issues CUDA work meanwhile. /state,
/envs and the hover pick read host state only (the scene's host tables).
`asgi_app(renderer)` serves the same routes as an ASGI application.

What the port refuses, with a message and without touching the
renderer: /load of "pdb:ID" (fetching from RCSB needs the network; load a
local file instead). A malformed request
answers 400 and changes nothing: bad JSON, a body that is not a JSON
object, or a field of /hover, /orbit, /fly, /light or /focus that is not
a finite number (an integer index, a list of keys) — the JAX server
raises on such a field and drops the connection.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..utils.png import encode_png, upsample_nearest

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ENV_ASSET_DIR = os.path.join(REPO_DIR, "assets", "env")
PROTEIN_ASSET_DIR = os.path.join(REPO_DIR, "assets", "proteins")
NO_PDB_FETCH = ("fetching {name} from RCSB needs the network, which the port does "
                "not use: load a local file (cli --pdb-file) or put it in "
                "assets/proteins/ and load protein:ID")

VIEWER_HTML = """<!DOCTYPE html>
<html><head><title>webgl_raytracer_tpu_torch viewer</title>
<style>
 body { background:#111; color:#ddd; font-family:monospace; margin:16px; }
 #frame { border:1px solid #444; cursor:grab; image-rendering:pixelated; }
 #status { margin-top:8px; white-space:pre; }
 #wrap { position:relative; display:inline-block; }
 #hoverbox { position:absolute; border:1px solid #7fc9ff; pointer-events:none;
             display:none; }
 #hoverlabel { position:absolute; color:#7fc9ff; font-size:11px;
               pointer-events:none; display:none; }
 #panel { margin-top:10px; max-width:720px; display:flex; flex-wrap:wrap;
          gap:10px 18px; font-size:12px; }
 #panel label { display:flex; align-items:center; gap:6px; }
 #panel input[type=range] { width:90px; }
 select { background:#222; color:#ddd; border:1px solid #555; }
</style></head>
<body>
<h3>webgl_raytracer_tpu_torch</h3>
<div id="wrap">
<img id="frame" src="/frame.png" draggable="false">
<div id="hoverbox"></div><div id="hoverlabel"></div>
</div>
<div id="status"></div>
<div id="panel">
<fieldset><legend>render</legend>
 <label>scale <input type="range" data-k="render_scale" data-num="1"
   min="0.25" max="2" step="0.25" value="1.0"></label>
 <label>fast scale <input type="range" data-k="fast_scale" data-num="1"
   min="0.05" max="1" step="0.05" value="0.25"></label>
 <label>spp <input type="range" data-k="samples_per_bounce" data-num="1"
   data-int="1" min="1" max="8" step="1" value="1"></label>
 <label>bounces <input type="range" data-k="max_bounces" data-num="1"
   data-int="1" min="1" max="8" step="1" value="4"></label>
 <label>max frames <input type="range" data-k="max_frames" data-num="1"
   data-int="1" min="0" max="2000" step="10" value="100"></label>
 <label>exposure <input type="range" data-k="exposure" data-num="1"
   min="0.1" max="4" step="0.1" value="1.0"></label>
 <label>tone map
  <select data-k="tone_map">
   <option>aces</option><option>linear</option><option>reinhard</option>
  </select></label>
 <label>vis
  <select data-k="vis_mode" data-num="1">
   <option value="0">render</option><option value="1">normals</option>
   <option value="2">cost</option><option value="3">depth</option>
  </select></label>
 <label><input type="checkbox" data-k="cast_shadows" checked> shadows</label>
 <label><input type="checkbox" data-k="use_bvh" checked> BVH</label>
 <label><input type="checkbox" data-k="use_imported_color" checked> imported color</label>
</fieldset>
<fieldset><legend>material</legend>
 <label>mode
  <select data-k="material_mode">
   <option>metallic</option><option>matte</option>
   <option>surface-glass</option><option>translucent-plastic</option>
  </select></label>
 <span data-mode="metallic">
 <label>metallic <input type="range" data-k="metallic" data-num="1"
   min="0" max="1" step="0.02" value="0.0"></label>
 <label>roughness <input type="range" data-k="roughness" data-num="1"
   min="0.02" max="1" step="0.02" value="0.4"></label>
 <label>rim <input type="range" data-k="rim_boost" data-num="1"
   min="0" max="2" step="0.05" value="0.2"></label>
 </span>
 <span data-mode="matte" style="display:none">
 <label>specular <input type="range" data-k="matte_specular" data-num="1"
   min="0" max="0.2" step="0.005" value="0.03"></label>
 <label>roughness <input type="range" data-k="matte_roughness" data-num="1"
   min="0.02" max="1" step="0.02" value="0.5"></label>
 <label>diffuse rough <input type="range" data-k="matte_diffuse_roughness"
   data-num="1" min="0" max="1" step="0.02" value="0.5"></label>
 <label>wrap <input type="range" data-k="wrap_diffuse" data-num="1"
   min="0" max="1" step="0.02" value="0.2"></label>
 </span>
 <span data-mode="surface-glass translucent-plastic" style="display:none">
 <label>ior <input type="range" data-k="surface_ior" data-num="1"
   min="1" max="2.5" step="0.01" value="1.33"></label>
 <label>transmission <input type="range" data-k="surface_transmission"
   data-num="1" min="0" max="1" step="0.02" value="0.35"></label>
 <label>opacity <input type="range" data-k="surface_opacity" data-num="1"
   min="0" max="1" step="0.02" value="0.0"></label>
 </span>
</fieldset>
<fieldset><legend>DoF / env / clip</legend>
 <label><input type="checkbox" data-k="dof_enabled"> DoF</label>
 <label>aperture <input type="range" data-k="dof_aperture" data-num="1"
   min="0" max="0.3" step="0.005" value="0.03"></label>
 <label>focus <input type="range" data-k="dof_focus_distance" data-num="1"
   min="0.1" max="40" step="0.1" value="4"></label>
 <label>env <input type="range" data-k="env_intensity" data-num="1"
   min="0" max="1" step="0.02" value="0.1"></label>
 <label>env clamp <input type="range" data-k="env_max_luminance" data-num="1"
   min="1" max="500" step="1" value="200"></label>
 <label>ambient <input type="range" data-k="ambient_intensity" data-num="1"
   min="0" max="1" step="0.02" value="0.0"></label>
 <label><input type="checkbox" data-k="clip_enabled"> clip</label>
 <label>clip dist <input type="range" data-k="clip_distance" data-num="1"
   min="-40" max="40" step="0.1" value="0"></label>
</fieldset>
<fieldset><legend>volume</legend>
 <label><input type="checkbox" data-k="volume_enabled"> enabled</label>
 <label>density <input type="range" data-k="volume_density" data-num="1"
   min="0" max="4" step="0.05" value="1"></label>
 <label>opacity <input type="range" data-k="volume_opacity" data-num="1"
   min="0" max="1" step="0.02" value="1"></label>
 <label>step <input type="range" data-k="volume_step" data-num="1"
   min="0.1" max="2" step="0.05" value="0.5"></label>
 <label>threshold <input type="range" data-k="volume_threshold" data-num="1"
   min="0" max="1" step="0.01" value="0"></label>
</fieldset>
<fieldset><legend>lights (key / fill / rim)</legend>
 <span data-light-row="0"></span>
 <span data-light-row="1"></span>
 <span data-light-row="2"></span>
</fieldset>
<fieldset><legend>environment (environment_controller.js:194-209)</legend>
 <label>source <select id="envSel">
  <option value="sky">analytic sky</option>
  <option value="off">lights only</option>
 </select></label>
 <span id="envMsg"></span>
</fieldset>
<fieldset><legend>analytic sky (index.html:702-788)</legend>
 <label><input type="checkbox" data-sky="enabled" checked> on</label>
 <label>turbidity <input type="range" data-sky="turbidity"
   min="1" max="10" step="0.1" value="2.5"></label>
 <label>sun az <input type="range" data-sky="sun_azimuth_deg"
   min="-180" max="180" step="1" value="30"></label>
 <label>sun el <input type="range" data-sky="sun_elevation_deg"
   min="-10" max="90" step="1" value="35"></label>
 <label>sky int <input type="range" data-sky="sky_intensity"
   min="0" max="5" step="0.1" value="1"></label>
 <label>sun int <input type="range" data-sky="sun_intensity"
   min="0" max="100" step="1" value="20"></label>
 <label>albedo <input type="range" data-sky="ground_albedo"
   min="0" max="1" step="0.02" value="0.2"></label>
 <label>sun radius <input type="range" data-sky="sun_angular_radius_deg"
   min="0.05" max="2" step="0.01" value="0.27"></label>
</fieldset>
<fieldset><legend>scene (index.html:530-551)</legend>
 <select id="sceneSel">
  <option value="primitives">test primitives</option>
  <option value="spheres1000">1000 random spheres</option>
  <option value="spheres10000">10000 random spheres</option>
  <option value="caffeine">caffeine</option>
  <option value="aspirin">aspirin</option>
  <option value="benzene">benzene</option>
  <option value="ethanol">ethanol</option>
  <option value="ibuprofen">ibuprofen</option>
  <option value="glucose">glucose</option>
  <option value="protein:TSTP">TSTP (bundled protein)</option>
 </select>
 <select id="styleSel">
  <option>ball-and-stick</option><option>vdw</option>
  <option>stick</option><option>cartoon</option>
 </select>
 <label><input type="checkbox" id="sesChk"> SES surface</label>
 <label>probe <input type="number" id="sesProbe" value="1.4" min="0.5"
  max="3.0" step="0.1" style="width:4em"></label>
 <label>res <input type="number" id="sesRes" value="0.5" min="0.2"
  max="2.0" step="0.05" style="width:4em"></label>
 <label><input type="checkbox" id="volChk"> volume</label>
 <label>grid Å <input type="number" id="volSpacing" value="0.5" min="0.2"
  max="1.5" step="0.05" style="width:4em"></label>
 <label>gauss ×VdW <input type="number" id="volGauss" value="3.0" min="1"
  max="6" step="0.1" style="width:4em"></label>
 <button id="loadBtn">load</button>
 <span id="loadMsg"></span>
</fieldset>
</div>
<script>
const img = document.getElementById('frame');
const status = document.getElementById('status');
let dragging = false, lastX = 0, lastY = 0, busy = false;
async function refresh() {
  if (busy) return;
  busy = true;
  try {
    const r = await fetch('/frame.png?' + Date.now());
    const blob = await r.blob();
    img.src = URL.createObjectURL(blob);
    const s = await (await fetch('/state')).json();
    status.textContent = `frame ${s.frame_index}/${s.max_frames}  ` +
      `${s.width}x${s.height}  ${s.prims} prims`;
  } finally { busy = false; }
}
setInterval(refresh, 150);
let dragStart = false;
img.addEventListener('pointerdown', e => { dragging = true; dragStart = true;
  lastX = e.clientX; lastY = e.clientY; });
window.addEventListener('pointerup', () => dragging = false);
window.addEventListener('pointermove', async e => {
  if (!dragging) return;
  const dx = e.clientX - lastX, dy = e.clientY - lastY;
  lastX = e.clientX; lastY = e.clientY;
  if (dx || dy) {
    // start rides the first move so the lock reset cannot race the moves
    const body = {dx, dy, start: dragStart};
    dragStart = false;
    await fetch('/orbit', {method:'POST', body: JSON.stringify(body)});
  }
});
const hoverbox = document.getElementById('hoverbox');
const hoverlabel = document.getElementById('hoverlabel');
let moved = false, hoverTimer = null;
img.addEventListener('pointermove', e => {
  if (dragging) { moved = true; return; }
  clearTimeout(hoverTimer);
  const rect = img.getBoundingClientRect();
  const x = e.clientX - rect.left, y = e.clientY - rect.top;
  hoverTimer = setTimeout(async () => {
    const h = await (await fetch(`/hover?x=${x}&y=${y}`)).json();
    if (h && h.rect) {
      hoverbox.style.display = 'block';
      hoverbox.style.left = h.rect.x + 'px';
      hoverbox.style.top = h.rect.y + 'px';
      hoverbox.style.width = h.rect.w + 'px';
      hoverbox.style.height = h.rect.h + 'px';
      hoverlabel.style.display = 'block';
      hoverlabel.style.left = h.rect.x + 'px';
      hoverlabel.style.top = (h.rect.y - 14) + 'px';
      hoverlabel.textContent = h.label + '  t=' + h.t.toFixed(2);
    } else { hoverbox.style.display = 'none'; hoverlabel.style.display = 'none'; }
  }, 60);
});
img.addEventListener('click', async e => {
  if (moved) { moved = false; return; }
  const rect = img.getBoundingClientRect();
  const x = e.clientX - rect.left, y = e.clientY - rect.top;
  const f = await (await fetch('/focus', {method:'POST',
      body: JSON.stringify({x, y})})).json();
  if (f.focus != null) status.textContent = 'focus -> ' + f.focus.toFixed(2);
});
window.addEventListener('keydown', async e => {
  if (e.target.tagName === 'SELECT' || e.target.tagName === 'INPUT') return;
  const k = e.key.toLowerCase();
  if ('wasdqe'.includes(k)) {
    await fetch('/fly', {method:'POST', body: JSON.stringify({keys:[k], dt:0.1})});
  } else if ('0123'.includes(k)) {
    await fetch('/settings', {method:'POST', body: JSON.stringify({vis_mode: +k})});
  }
});
document.querySelectorAll('#panel [data-k]').forEach(el => {
  el.addEventListener('change', async () => {
    const key = el.dataset.k;
    let val;
    if (el.type === 'checkbox') val = el.checked;
    else if (el.dataset.num) val = el.dataset.int ? parseInt(el.value) : parseFloat(el.value);
    else val = el.value;
    await fetch('/settings', {method:'POST', body: JSON.stringify({[key]: val})});
    if (key === 'material_mode') updateModePanels(val);
  });
});
// Material-mode panel visibility (ui_controller.js:23-33).
function updateModePanels(mode) {
  document.querySelectorAll('#panel [data-mode]').forEach(sp => {
    sp.style.display = sp.dataset.mode.split(' ').includes(mode) ? '' : 'none';
  });
}
// Per-light sliders (key/fill/rim, main.js:194-199 defaults).
const lightDefs = [
  {az: -40, el: -30, it: 5.0, an: 22, on: true},
  {az: 40, el: 0, it: 0.6, an: 50, on: true},
  {az: 170, el: 10, it: 0.35, an: 6, on: true}];
document.querySelectorAll('[data-light-row]').forEach(row => {
  const i = +row.dataset.lightRow;
  const d = lightDefs[i];
  row.innerHTML =
    `<label><input type="checkbox" data-li="${i}" data-lk="enabled"` +
    `${d.on ? ' checked' : ''}> L${i}</label>` +
    `<label>az <input type="range" data-li="${i}" data-lk="azimuth"` +
    ` min="-180" max="180" step="1" value="${d.az}"></label>` +
    `<label>el <input type="range" data-li="${i}" data-lk="elevation"` +
    ` min="-89" max="89" step="1" value="${d.el}"></label>` +
    `<label>int <input type="range" data-li="${i}" data-lk="intensity"` +
    ` min="0" max="8" step="0.05" value="${d.it}"></label>` +
    `<label>angle <input type="range" data-li="${i}" data-lk="angle"` +
    ` min="1" max="60" step="1" value="${d.an}"></label>`;
});
document.querySelectorAll('[data-lk]').forEach(el => {
  el.addEventListener('change', async () => {
    const val = el.type === 'checkbox' ? el.checked : parseFloat(el.value);
    await fetch('/light', {method:'POST', body: JSON.stringify(
      {index: +el.dataset.li, [el.dataset.lk]: val})});
  });
});
// Environment source select, populated from the HDR manifest
// (environment_controller.js:194-209).
const envSel = document.getElementById('envSel');
(async () => {
  const m = await (await fetch('/envs')).json();
  for (const e of m.environments || []) {
    const o = document.createElement('option');
    o.value = 'hdr:' + e.file;
    o.textContent = 'HDR: ' + (e.name || e.file);
    envSel.appendChild(o);
  }
  if (m.mode === 'hdr' && m.file) envSel.value = 'hdr:' + m.file;
  else envSel.value = m.mode;
})();
envSel.addEventListener('change', async () => {
  const v = envSel.value;
  const body = v.startsWith('hdr:') ? {mode: 'hdr', file: v.slice(4)}
                                    : {mode: v};
  const r = await (await fetch('/env', {method:'POST',
      body: JSON.stringify(body)})).json();
  document.getElementById('envMsg').textContent =
      r.ok ? '' : (r.error || 'failed');
});
// Analytic-sky sliders regenerate the env (environment_controller.js:167-192).
document.querySelectorAll('[data-sky]').forEach(el => {
  el.addEventListener('change', async () => {
    const val = el.type === 'checkbox' ? el.checked : parseFloat(el.value);
    await fetch('/sky', {method:'POST',
      body: JSON.stringify({[el.dataset.sky]: val})});
  });
});
// In-session scene switching (main.js:1900-1934).
document.getElementById('loadBtn').addEventListener('click', async () => {
  const msg = document.getElementById('loadMsg');
  msg.textContent = 'loading...';
  const r = await (await fetch('/load', {method:'POST', body: JSON.stringify({
    scene: document.getElementById('sceneSel').value,
    style: document.getElementById('styleSel').value,
    surface: document.getElementById('sesChk').checked,
    probe_radius: parseFloat(document.getElementById('sesProbe').value),
    surface_resolution: parseFloat(document.getElementById('sesRes').value),
    volume: document.getElementById('volChk').checked,
    grid_spacing: parseFloat(document.getElementById('volSpacing').value),
    gaussian_scale: parseFloat(document.getElementById('volGauss').value),
  })})).json();
  msg.textContent = r.ok ? `${r.prims} prims` : (r.error || 'failed');
});
</script>
</body></html>
"""


class ViewerState:
    # Seconds after the last camera/settings input before the renderer
    # returns from the interactive fast_scale to the full render_scale.
    SETTLE_SECONDS = 0.6

    def __init__(self, renderer, logger=None, sky_params=None, env_enabled=True):
        self.renderer = renderer
        self.logger = logger
        self.lock = threading.Lock()
        self._last_input = 0.0
        self._rotate_lock = None   # first-drag yaw/pitch axis lock
        # Environment state: "sky" (analytic), "hdr" (a manifest asset) or
        # "off" (lights only). Sky params persist across mode switches.
        self._sky = dict(sky_params or {})
        self._env_mode = "sky" if env_enabled else "off"
        self._hdr_file = None
        self._env_ctrl = None

    def _controller(self):
        if self._env_ctrl is None:
            from ..env import EnvironmentController

            self._env_ctrl = EnvironmentController(asset_dir=ENV_ASSET_DIR, logger=self.logger,
                                                   device=self.renderer.device)
        return self._env_ctrl

    def env_manifest(self) -> dict:
        """Available HDR environments and the current selection."""
        return {"environments": self._controller().manifest(),
                "mode": self._env_mode, "file": self._hdr_file}

    def update_env(self, spec: dict) -> dict:
        """Environment source switch: {"mode": "off"|"sky"|"hdr", "file":
        name}. HDR files resolve only through the manifest (no paths from
        the network)."""
        mode = str(spec.get("mode", "sky"))
        if mode not in ("off", "sky", "hdr"):
            return {"ok": False, "error": f"unknown env mode: {mode}"}
        with self.lock:
            ctrl = self._controller()
            if mode == "off":
                ctrl.clear()
                self.renderer.set_env(None)
                self._env_mode = "off"
            elif mode == "sky":
                self.renderer.set_env(ctrl.load_analytic_sky(**self._sky))
                self._env_mode = "sky"
            else:
                want = os.path.basename(str(spec.get("file", "")))
                entry = next((e for e in ctrl.manifest()
                              if e.get("file") == want or e.get("name") == want), None)
                if entry is None:
                    return {"ok": False, "error": f"not in the env manifest: {want}"}
                try:
                    env = ctrl.load_hdr_file(os.path.join(ctrl.asset_dir, entry["file"]))
                except Exception as exc:
                    if self.logger:
                        self.logger.error(f"env load failed: {exc}")
                    return {"ok": False, "error": str(exc)}
                self.renderer.set_env(env)
                self._env_mode = "hdr"
                self._hdr_file = entry["file"]
            self._interactive()
            return {"ok": True, "mode": self._env_mode,
                    "file": self._hdr_file if mode == "hdr" else None}

    def _interactive(self) -> None:
        """Mark a camera/settings input: drop to the fast preview scale."""
        self._last_input = time.monotonic()
        s = self.renderer.settings
        if s.fast_scale < s.render_scale:
            self.renderer.set_scale(s.fast_scale)

    def _maybe_settle(self) -> None:
        s = self.renderer.settings
        if (self.renderer.scale != s.render_scale
                and time.monotonic() - self._last_input > self.SETTLE_SECONDS):
            self.renderer.set_scale(s.render_scale)

    def frame_png(self) -> bytes:
        """Advance one frame; the PNG of the image at the base size (the
        nearest-neighbour resize while the renderer's scale differs)."""
        with self.lock:
            self._maybe_settle()
            r = self.renderer
            r.render_frame()
            img = r.image_u8()
            base = (r.base_width, r.base_height)
        if img.shape[:2] != base[::-1]:
            img = upsample_nearest(img, *base)
        return encode_png(img)

    def state(self) -> dict:
        r = self.renderer
        return {
            "frame_index": r.frame_index,
            "max_frames": r.settings.max_frames,
            "width": r.width,
            "height": r.height,
            "prims": r.scene.prim_count,
            "camera": {"target": [float(v) for v in np.asarray(r.camera.target)],
                       "distance": float(r.camera.distance)},
            "vis_mode": r.settings.vis_mode,
        }

    def orbit(self, dx: float, dy: float, start: bool = False) -> None:
        """Orbit drag with the first-drag axis lock: the dominant delta
        locks the drag to yaw or pitch; motion under the threshold before
        the lock resolves is ignored. `start` rides the first move, so it
        cannot race the moves that follow."""
        from ..scene.camera import resolve_rotation_lock

        with self.lock:
            if start:
                self._rotate_lock = None
                if dx == 0 and dy == 0:
                    return
            self._rotate_lock = resolve_rotation_lock(self._rotate_lock, dx, dy)
            if self._rotate_lock is None:
                return
            ldx = dx if self._rotate_lock == "yaw" else 0.0
            ldy = dy if self._rotate_lock == "pitch" else 0.0
            self.renderer.camera.drag(ldx, ldy)
            self._interactive()
            self.renderer.reset_accumulation()

    def fly(self, keys, dt: float) -> None:
        with self.lock:
            if self.renderer.camera.fly(keys, dt):
                self._interactive()
                self.renderer.reset_accumulation()

    def _display_to_render(self, x: float, y: float):
        """Display (base-size) pixel -> the pixel at the current internal
        resolution."""
        r = self.renderer
        return (x * r.width / r.base_width, y * r.height / r.base_height)

    def hover(self, x: float, y: float):
        """Hover query: primitive label, t and the projected AABB rect in
        display coordinates."""
        from ..render.picking import hover_at_pixel

        with self.lock:
            r = self.renderer
            h = hover_at_pixel(r, *self._display_to_render(x, y))
            if h is None:
                return None
            sx = r.base_width / r.width
            sy = r.base_height / r.height
            rect = None
            if h.rect is not None:
                rect = {"x": h.rect["min_x"] * sx, "y": h.rect["min_y"] * sy,
                        "w": h.rect["width"] * sx, "h": h.rect["height"] * sy}
            return {"label": h.label, "t": float(h.hit.t),
                    "prim_type": int(h.hit.prim_type),
                    "prim_index": int(h.hit.prim_index), "rect": rect}

    def focus(self, x: float, y: float):
        """Click-to-focus: dof_focus_distance <- the hit distance."""
        from ..render.picking import autofocus_at_pixel

        with self.lock:
            d = autofocus_at_pixel(self.renderer, *self._display_to_render(x, y))
            if d is not None:
                self.renderer.reset_accumulation()
            return d

    def update_settings(self, updates: dict) -> None:
        """Validated settings update: only RenderSettings scalar fields are
        writable, values are coerced to the field's type and enum fields
        checked, so a malformed POST cannot wedge the next /frame.png."""
        from ..render.config import (MATERIAL_MODES, TONE_MAPS, apply_material_preset,
                                     clip_distance_max)

        enums = {"material_mode": set(MATERIAL_MODES), "tone_map": set(TONE_MAPS),
                 "tracer": {"wavefront", "stack"}}
        with self.lock:
            s = self.renderer.settings
            for key, value in updates.items():
                if key.startswith("_") or not hasattr(s, key):
                    continue
                current = getattr(s, key)
                try:
                    if isinstance(current, bool):
                        value = bool(value)
                    elif isinstance(current, int):
                        value = int(value)
                    elif isinstance(current, float):
                        value = float(value)
                    elif isinstance(current, str):
                        value = str(value)
                        if key in enums and value not in enums[key]:
                            raise ValueError(value)
                    elif isinstance(current, tuple):
                        value = tuple(float(v) for v in value)
                        if len(value) != len(current):
                            raise ValueError(value)
                    else:
                        continue   # lights and clip state have their own routes
                except (TypeError, ValueError):
                    if self.logger:
                        self.logger.warn(f"rejected setting {key}={value!r}")
                    continue
                if key == "max_frames":
                    value = int(min(max(value, 0), 2000))
                if key == "clip_distance":
                    lim = clip_distance_max(self.renderer.scene_scale)
                    value = float(min(max(value, -lim), lim))
                setattr(s, key, value)
                if key == "material_mode" and apply_material_preset(s, value):
                    if self.logger:
                        self.logger.info("Applied preset: Translucent Plastic")
            self._interactive()
            self.renderer.reset_accumulation()

    def update_light(self, index: int, updates: dict) -> None:
        """Validated per-light update: index 0-2, fields coerced as in
        update_settings."""
        with self.lock:
            lights = self.renderer.settings.lights
            if not 0 <= index < len(lights):
                return
            li = lights[index]
            for key, value in updates.items():
                if key.startswith("_") or not hasattr(li, key):
                    continue
                current = getattr(li, key)
                try:
                    if isinstance(current, bool):
                        value = bool(value)
                    elif isinstance(current, float):
                        value = float(value)
                    elif isinstance(current, tuple):
                        value = tuple(float(v) for v in value)
                        if len(value) != len(current):
                            raise ValueError(value)
                    else:
                        continue
                except (TypeError, ValueError):
                    if self.logger:
                        self.logger.warn(f"rejected light {index} {key}={value!r}")
                    continue
                setattr(li, key, value)
            self._interactive()
            self.renderer.reset_accumulation()

    def update_sky(self, updates: dict) -> dict:
        """Partial analytic-sky update: merge validated params, regenerate
        the env (the controller's cache dedups identical settings), swap it
        in and reset accumulation. {"enabled": false} tears the environment
        down to lights only; a sky update while an HDR is shown returns to
        the sky."""
        from ..env.sky import normalize_analytic_sky_settings

        with self.lock:
            if "enabled" in updates:
                self._env_mode = "sky" if bool(updates.pop("enabled")) else "off"
            elif self._env_mode == "hdr":
                self._env_mode = "sky"
            params = dict(self._sky)
            for key, value in updates.items():
                if key in ("width", "height"):
                    continue          # the image size is not a live control
                params[key] = value
            try:
                normalize_analytic_sky_settings(**params)
            except (TypeError, ValueError) as exc:
                if self.logger:
                    self.logger.warn(f"rejected sky update: {exc}")
                return {"ok": False, "error": str(exc)}
            self._sky = params
            if self._env_mode == "sky":
                env = self._controller().load_analytic_sky(**params)
            else:
                self._controller().clear()
                env = None
            self.renderer.set_env(env)
            self._interactive()
            return {"ok": True, "enabled": self._env_mode == "sky"}

    def load_scene(self, spec: dict) -> dict:
        """In-session scene switch: the synthetic test scenes, the built-in
        molecules and the bundled proteins (protein:ID). The viewer lock
        doubles as the loading guard. pdb:ID is refused (NO_PDB_FETCH)."""
        from ..models import get_builtin_molecule, parse_auto_detect
        from ..models.molecular import BUILTIN_MOLECULE_NAMES
        from .pipeline import (DISPLAY_STYLES, load_molecule_scene, load_random_spheres,
                               load_test_primitives)

        name = str(spec.get("scene", ""))
        style = str(spec.get("style", "ball-and-stick"))
        if style not in DISPLAY_STYLES:
            return {"ok": False, "error": f"unknown style: {style}"}
        surface = bool(spec.get("surface", False))
        volume = bool(spec.get("volume", False))
        try:
            probe = float(spec.get("probe_radius", 1.4))
            resolution = float(spec.get("surface_resolution", 0.5))
            vol_spacing = float(spec.get("grid_spacing", 0.5))
            vol_gauss = float(spec.get("gaussian_scale", 3.0))
        except (TypeError, ValueError):
            return {"ok": False, "error": "bad probe/resolution/volume params"}
        if not 0.2 <= vol_spacing <= 1.5:
            return {"ok": False, "error": f"grid_spacing out of range: {vol_spacing}"}
        if not 1.0 <= vol_gauss <= 6.0:
            return {"ok": False, "error": f"gaussian_scale out of range: {vol_gauss}"}
        # The CLI's limits: probe in the slider's range, resolution floored
        # so that a stray 0.01 cannot build a 1e9-cell grid on a live server.
        if not 0.5 <= probe <= 3.0:
            return {"ok": False, "error": f"probe_radius out of range: {probe}"}
        if not 0.2 <= resolution <= 2.0:
            return {"ok": False, "error": f"surface_resolution out of range: {resolution}"}
        with self.lock:
            device = self.renderer.device
            try:
                if name == "primitives":
                    loaded = load_test_primitives(device=device)
                elif name.startswith("spheres"):
                    count = int(name[len("spheres"):] or 1000)
                    if not 1 <= count <= 1_000_000:
                        raise ValueError(f"sphere count out of range: {count}")
                    loaded = load_random_spheres(count, device=device)
                else:
                    if name in BUILTIN_MOLECULE_NAMES:
                        mol = get_builtin_molecule(name)
                    elif name.startswith("protein:"):
                        asset = os.path.join(PROTEIN_ASSET_DIR,
                                             name[len("protein:"):] + ".pdb")
                        if not os.path.isfile(asset):
                            raise ValueError(f"no bundled protein {name}")
                        with open(asset, encoding="utf-8") as f:
                            mol = parse_auto_detect(f.read(), asset)
                    elif name.startswith("pdb:"):
                        raise ValueError(NO_PDB_FETCH.format(name=name))
                    else:
                        raise ValueError(f"unknown scene: {name}")
                    loaded = load_molecule_scene(
                        mol, display_style=style, show_surface=surface,
                        probe_radius=probe, surface_resolution=resolution,
                        volume_enabled=volume,
                        volume_options=dict(spacing=vol_spacing, gaussian_scale=vol_gauss),
                        logger=self.logger, device=device)
            except Exception as exc:   # load failures answer 200 with the error
                if self.logger:
                    self.logger.error(f"scene load failed: {exc}")
                return {"ok": False, "error": str(exc)}
            vol = (loaded.volume.to_device_buffers(device)
                   if loaded.volume is not None else None)
            self.renderer.set_scene(loaded.scene, volume=vol)
            self.renderer.settings.volume_enabled = vol is not None
            if self.logger:
                self.logger.info(f"Loaded {name}: {loaded.scene.prim_count} prims")
            return {"ok": True, "scene": name, "prims": int(self.renderer.scene.prim_count)}


JSON = "application/json"
NOT_FOUND = (404, b'{"error": "not found"}', JSON)


def _json(obj) -> tuple:
    return 200, json.dumps(obj).encode(), JSON


class BadRequest(ValueError):
    """A request field of the wrong type: the answer is 400."""


def _finite(value) -> float:
    value = float(value)
    if not math.isfinite(value):
        raise ValueError(value)
    return value


def _field(data: dict, key: str, default, kind=_finite):
    """data[key] (default when absent) as `kind`; BadRequest when it is
    not one."""
    value = data.get(key, default)
    try:
        return kind(value)
    except (TypeError, ValueError, OverflowError):
        raise BadRequest(f"bad {key}: {value!r}") from None


def handle(state: ViewerState, method: str, path: str, query: str, body: bytes) -> tuple:
    """One request -> (status, body bytes, content type). The stdlib
    handler and the ASGI app both answer through here. Bad JSON, a body
    that is not a JSON object and a field of the wrong type answer 400."""
    try:
        return _route(state, method, path, query, body)
    except BadRequest as exc:
        return 400, json.dumps({"error": str(exc)}).encode(), JSON


def _route(state: ViewerState, method: str, path: str, query: str, body: bytes) -> tuple:
    if method == "GET":
        if path == "/":
            return 200, VIEWER_HTML.encode(), "text/html; charset=utf-8"
        if path == "/frame.png":
            return 200, state.frame_png(), "image/png"
        if path == "/state":
            return _json(state.state())
        if path == "/envs":
            return _json(state.env_manifest())
        if path == "/hover":
            q = {key: values[0] for key, values in parse_qs(query).items()}
            return _json(state.hover(_field(q, "x", 0), _field(q, "y", 0)))
        return NOT_FOUND
    if method != "POST":
        return NOT_FOUND
    try:
        data = json.loads(body or b"{}")
    except (json.JSONDecodeError, UnicodeDecodeError):
        raise BadRequest("bad json") from None
    if not isinstance(data, dict):
        raise BadRequest("the body must be a JSON object")
    if path == "/orbit":
        state.orbit(_field(data, "dx", 0), _field(data, "dy", 0),
                    start=bool(data.get("start", False)))
    elif path == "/fly":
        state.fly(_field(data, "keys", [], frozenset), _field(data, "dt", 0.016))
    elif path == "/settings":
        state.update_settings(data)
    elif path == "/light":
        index = _field(data, "index", -1, int)
        data.pop("index", None)
        state.update_light(index, data)
    elif path == "/sky":
        return _json(state.update_sky(data))
    elif path == "/env":
        return _json(state.update_env(data))
    elif path == "/load":
        return _json(state.load_scene(data))
    elif path == "/focus":
        d = state.focus(_field(data, "x", 0), _field(data, "y", 0))
        return _json({"focus": None if d is None else float(d)})
    else:
        return NOT_FOUND
    return 200, b'{"ok": true}', JSON


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def _answer(self, method: str, body: bytes = b"") -> None:
            parsed = urlparse(self.path)
            code, out, ctype = handle(state, method, parsed.path, parsed.query, body)
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(out)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(out)

        def do_GET(self):
            self._answer("GET")

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            self._answer("POST", self.rfile.read(length))

        def log_message(self, fmt, *args):
            if state.logger:
                state.logger.info(f"[http] {fmt % args}")

    return Handler


def make_server(renderer, host="127.0.0.1", port=8000, logger=None, sky_params=None,
                env_enabled=True) -> ThreadingHTTPServer:
    """The viewer's HTTP server, bound but not yet serving (port 0 picks a
    free port: server.server_address has it). Its ViewerState is
    server.state."""
    state = ViewerState(renderer, logger, sky_params=sky_params, env_enabled=env_enabled)
    server = ThreadingHTTPServer((host, port), make_handler(state))
    server.state = state
    return server


def serve(renderer, host="127.0.0.1", port=8000, logger=None, sky_params=None,
          env_enabled=True):
    server = make_server(renderer, host, port, logger, sky_params, env_enabled)
    if logger:
        logger.info(f"Viewer at http://{host}:{server.server_address[1]}/ (Ctrl-C to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


def asgi_app(renderer, logger=None, sky_params=None, env_enabled=True):
    """The same routes as an ASGI application (run it with any ASGI
    server)."""
    state = ViewerState(renderer, logger, sky_params=sky_params, env_enabled=env_enabled)

    async def app(scope, receive, send):
        if scope["type"] != "http":
            return
        body = b""
        if scope["method"] == "POST":
            while True:
                event = await receive()
                body += event.get("body", b"")
                if not event.get("more_body"):
                    break
        code, out, ctype = handle(state, scope["method"], scope["path"],
                                  scope.get("query_string", b"").decode(), body)
        await send({"type": "http.response.start", "status": code,
                    "headers": [(b"content-type", ctype.encode()),
                                (b"cache-control", b"no-store")]})
        await send({"type": "http.response.body", "body": out})

    app.state = state
    return app
