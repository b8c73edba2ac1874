"""Headless 3D beamline viewer: the capability analog of xrtGlow.

Port of the reference package's ``glow.py``.  The reference ships a
Qt/OpenGL application (xrt/gui/xrtGlow/widgets/main.py) that draws the
beamline elements as 3D surfaces and the traced beams as energy-coloured
segments with draggable views.  Here the same capability comes without a
GUI toolkit: :func:`export_html` writes a standalone HTML file with an
embedded pure-JS canvas renderer (orbit by drag, zoom by wheel, no
network), and :func:`export_png` renders the same scene to a static
matplotlib 3D figure.

Scene content:

* every OE surface as a wireframe mesh sampled from ``local_z`` over its
  physical limits and placed with ``local_to_global``, evaluated in the
  element's dtype on its device;
* apertures and screens as rectangles in their (ex, ey, ez) frames;
* beams (a ``{name: Beam}`` dict, e.g. from ``bl.propagate_flow`` or a
  flow replay) as per-ray polylines between consecutive elements,
  coloured by energy over the standard xrt hue range and dimmed for rays
  that are not good.

The beams stay on their device: the rays drawn are picked there by index
and only those ``maxRays`` values of each column are copied to the host.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import config

_MAX_SURF = 24          # wireframe grid resolution per OE
_MAX_RAYS = 200         # polyline subsample


def _energy_color(E, Emin, Emax):
    """xrt-style hue (blue->red over the energy range) as (r, g, b)."""
    if Emax <= Emin:
        h = np.full_like(np.asarray(E, float), 0.5)
    else:
        h = (np.asarray(E, float) - Emin) / (Emax - Emin)
    h = np.clip(h, 0, 1) * 0.85
    # HSV (h in [0, 0.85], s=1, v=1) -> RGB, vectorized
    i = np.floor(h * 6).astype(int)
    f = h * 6 - i
    q = 1 - f
    r = np.choose(i % 6, [1, q, 0, 0, f, 1])
    g = np.choose(i % 6, [f, 1, 1, q, 0, 0])
    b = np.choose(i % 6, [0, 0, f, 1, 1, q])
    return np.stack([r, g, b], -1)


def _host_vec(v):
    """A vector parameter (a tuple of numbers or tensors, or a tensor) as a
    float64 numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().double().cpu().numpy()
    return np.array([config.host_float(c) for c in v], float)


def _frame_of(obj, depth=4):
    """(dtype, device) an object computes in: its own ``dtype`` and
    ``device`` (a source's, a material element's), else those of the first
    floating tensor or such object among its attributes, *depth* levels
    down (an OE's material's element tables); None if there is none."""
    if isinstance(obj, torch.Tensor):
        return (obj.dtype, obj.device) if obj.is_floating_point() else None
    dt, dev = getattr(obj, 'dtype', None), getattr(obj, 'device', None)
    if isinstance(dt, torch.dtype) and dt.is_floating_point and \
            dev is not None:
        return dt, torch.device(dev)
    if depth == 0 or isinstance(obj, (str, bytes, int, float, type)):
        return None
    if isinstance(obj, (tuple, list)):
        items = obj
    elif hasattr(obj, '__dict__'):
        items = vars(obj).values()
    else:
        return None
    for v in items:
        hit = _frame_of(v, depth - 1)
        if hit is not None:
            return hit
    return None


def _oe_wireframe(oe, n=_MAX_SURF, frame=None):
    """Sample the OE surface over its physical limits and transform the
    grid to global coordinates; returns lists of 3D polylines.  The grid
    is evaluated in the element's dtype on its device (*frame*, a
    (dtype, device) pair, where the element has no tensor of its own).

    An element without a surface height falls back to a flat plane: only
    the errors such an element raises (``AttributeError``,
    ``NotImplementedError``) are caught; any other (a failed launch, a CUDA
    error) propagates."""
    from .beam import new_beam
    try:
        xlim = (float(oe.limPhysX[0]), float(oe.limPhysX[1]))
        ylim = (float(oe.limPhysY[0]), float(oe.limPhysY[1]))
    except (TypeError, AttributeError):
        return []
    if not all(map(math.isfinite, xlim + ylim)):
        xlim = tuple(np.clip(xlim, -50, 50))
        ylim = tuple(np.clip(ylim, -100, 100))
    xs = np.linspace(xlim[0], xlim[1], n)
    ys = np.linspace(ylim[0], ylim[1], n)
    X, Y = np.meshgrid(xs, ys)
    dt, dev = _frame_of(oe) or frame or \
        (torch.float64, config.resolve_device(None))
    xf = torch.as_tensor(X.ravel(), dtype=dt, device=dev)
    yf = torch.as_tensor(Y.ravel(), dtype=dt, device=dev)
    try:
        if getattr(oe, 'isParametric', False):
            s, phi, _ = oe.xyz_to_param(xf, yf, torch.zeros_like(xf))
            r = oe.local_r(s, phi)
            zf = oe.param_to_xyz(s, phi, r)[2]
        else:
            zf = oe.local_z(xf, yf)
    except (AttributeError, NotImplementedError):
        zf = torch.zeros_like(xf)
    lb = new_beam(xf.shape[0], dtype=dt, device=dev).replace(
        x=xf, y=yf, z=zf)
    glo = oe.local_to_global(lb)
    P = torch.stack([glo.x, glo.y, glo.z], -1).detach().cpu().numpy()
    P = P.reshape(n, n, 3)
    lines = [P[i].tolist() for i in range(0, n, 4)] + \
            [P[:, j].tolist() for j in range(0, n, 4)]
    return lines


def _frame_rect(el, halfx, halfz):
    """Rectangle polyline for an aperture/screen with an (ex, ey, ez)
    frame."""
    c = _host_vec(el.center)
    ex = _host_vec(el.ex)
    ez = _host_vec(el.ez)
    pts = []
    for sx, sz in ((-1, -1), (1, -1), (1, 1), (-1, 1), (-1, -1)):
        pts.append((c + sx * halfx * ex + sz * halfz * ez).tolist())
    return [pts]


def _element_lines(name, el, frame=None):
    if hasattr(el, 'rotationSequence') and hasattr(el, 'local_to_global'):
        return _oe_wireframe(el, frame=frame), '#8ecae6'
    if hasattr(el, 'ex'):
        halfx = halfz = 5.0
        if hasattr(el, 'left') and el.left is not None:
            halfx = max(abs(config.host_float(el.left)),
                        abs(config.host_float(el.right)))
            halfz = max(abs(config.host_float(el.bottom)),
                        abs(config.host_float(el.top)))
            color = '#ffb703'
        elif hasattr(el, 'r') and el.r is not None:
            halfx = halfz = config.host_float(el.r)
            color = '#ffb703'
        else:
            color = '#c8c8c8'   # screen
        return _frame_rect(el, halfx * 1.2, halfz * 1.2), color
    if hasattr(el, 'center'):
        c = _host_vec(el.center).tolist()
        d = 2.0
        return ([[[c[0] - d, c[1], c[2]], [c[0] + d, c[1], c[2]]],
                 [[c[0], c[1], c[2] - d], [c[0], c[1], c[2] + d]]],
                '#f07167')
    return [], '#888888'


def _picked(b, idx):
    """(x, y, z, E, state) of the rays *idx* of beam *b*: picked on the
    beam's device and copied to the host in one transfer of 5 x len(idx)
    values, in the beam's dtype."""
    ix = torch.as_tensor(idx, device=b.x.device)
    cols = torch.stack([b.x[ix], b.y[ix], b.z[ix], b.E[ix],
                        b.state[ix].to(b.x.dtype)])
    return cols.detach().cpu().numpy()


def build_scene(bl=None, elements: Optional[Dict[str, Any]] = None,
                beams: Optional[Dict[str, Any]] = None,
                maxRays=_MAX_RAYS) -> dict:
    """Collect the drawable scene: element wireframes + beam polylines.

    *beams* is an ordered ``{name: Beam}`` of GLOBAL beams along the flow
    (e.g. from ``bl.propagate_flow``); per-ray positions at consecutive
    beams are joined into segments."""
    if elements is None:
        elements = dict(getattr(bl, '_elements', {}) or {})
    scene = {'elements': [], 'segments': [], 'title': getattr(
        bl, 'name', '') or 'beamline'}
    # keep only global-frame ray beams (skip footprint locals)
    chain = [(n, b) for n, b in (beams or {}).items()
             if hasattr(b, 'x') and not n.endswith('_local')
             and not n.endswith('_local1') and not n.endswith('_local2')]
    # where an element holds no tensor of its own, its surface is
    # evaluated in the beams' dtype on their device (else a source's)
    frame = _frame_of(chain[0][1].x) if chain else None
    if frame is None:
        for el in elements.values():
            if hasattr(el, 'shine'):
                frame = _frame_of(el)
                if frame is not None:
                    break
    for name, el in elements.items():
        lines, color = _element_lines(name, el, frame)
        if lines:
            scene['elements'].append(
                {'name': name, 'color': color, 'lines': lines})

    if chain:
        nrays = int(chain[0][1].x.shape[0])
        idx = np.linspace(0, nrays - 1, min(maxRays, nrays)).astype(int)
        picked = [_picked(b, idx) for _, b in chain]
        allE = np.concatenate([p[3] for p in picked])
        Emin, Emax = float(allE.min()), float(allE.max())
        for (n1, _), (n2, _), p1, p2 in zip(chain[:-1], chain[1:],
                                            picked[:-1], picked[1:]):
            good = p2[4] == 1
            col = _energy_color(p2[3], Emin, Emax)
            segs = np.stack([p1[:3].T, p2[:3].T], 1)
            scene['segments'].append({
                'from': n1, 'to': n2,
                'p': np.round(segs, 4).tolist(),
                'rgb': np.round(col, 3).tolist(),
                'good': good.astype(int).tolist()})
    return scene


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ margin:0; background:#101018; color:#ddd;
        font:13px sans-serif; overflow:hidden }}
 #hud {{ position:absolute; left:10px; top:8px; pointer-events:none }}
 canvas {{ display:block }}
</style></head><body>
<div id="hud">{title} &mdash; drag: orbit &middot; wheel: zoom &middot;
 shift-drag: pan</div>
<canvas id="c"></canvas>
<script>
const SCENE = {scene_json};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function resize() {{ W = cv.width = innerWidth;
  H = cv.height = innerHeight; }} resize(); onresize = resize;
// bounds
let mn=[1e30,1e30,1e30], mx=[-1e30,-1e30,-1e30];
function acc(p) {{ for (let k=0;k<3;k++) {{
  mn[k]=Math.min(mn[k],p[k]); mx[k]=Math.max(mx[k],p[k]); }} }}
SCENE.elements.forEach(e=>e.lines.forEach(l=>l.forEach(acc)));
SCENE.segments.forEach(s=>s.p.forEach(pr=>pr.forEach(acc)));
const ctr=[0,1,2].map(k=>(mn[k]+mx[k])/2);
const span=Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2],1e-9);
let yaw=0.6, pit=0.35, zoom=0.9/span, panX=0, panY=0;
function proj(p) {{
  const x=p[0]-ctr[0], y=p[1]-ctr[1], z=p[2]-ctr[2];
  const cy=Math.cos(yaw), sy=Math.sin(yaw);
  const cp=Math.cos(pit), sp=Math.sin(pit);
  const X = cy*y - sy*x;          // beamline y (beam axis) horizontal
  const Y0 = cy*x + sy*y;
  const Y = cp*z - sp*Y0;
  return [W/2 + (X*zoom)*W*0.9 + panX, H/2 - (Y*zoom)*W*0.9 + panY];
}}
function draw() {{
  ctx.clearRect(0,0,W,H);
  // beams first (under the elements' wireframes)
  SCENE.segments.forEach(s => {{
    for (let i=0;i<s.p.length;i++) {{
      const a=proj(s.p[i][0]), b=proj(s.p[i][1]), c=s.rgb[i];
      ctx.strokeStyle = `rgba(${{255*c[0]|0}},${{255*c[1]|0}},` +
        `${{255*c[2]|0}},${{s.good[i] ? 0.55 : 0.08}})`;
      ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);
      ctx.stroke();
    }}
  }});
  SCENE.elements.forEach(e => {{
    ctx.strokeStyle = e.color; ctx.globalAlpha = 0.9;
    e.lines.forEach(l => {{
      ctx.beginPath();
      l.forEach((p,i) => {{ const q=proj(p);
        i ? ctx.lineTo(q[0],q[1]) : ctx.moveTo(q[0],q[1]); }});
      ctx.stroke();
    }});
    const q = proj(e.lines[0][0]);
    ctx.fillStyle = e.color; ctx.fillText(e.name, q[0]+4, q[1]-4);
    ctx.globalAlpha = 1;
  }});
}}
let drag=null;
cv.onmousedown = e => drag=[e.clientX,e.clientY,e.shiftKey];
onmouseup = () => drag=null;
onmousemove = e => {{ if (!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if (drag[2]) {{ panX+=dx; panY+=dy; }}
  else {{ yaw+=dx*0.008; pit+=dy*0.008; }}
  drag=[e.clientX,e.clientY,drag[2]]; draw(); }};
cv.onwheel = e => {{ zoom *= Math.exp(-e.deltaY*0.001); draw();
  e.preventDefault(); }};
draw();
</script></body></html>
"""


def export_html(bl=None, elements=None, beams=None, fileName='glow.html',
                maxRays=_MAX_RAYS) -> str:
    """Write a standalone interactive 3D HTML view (no dependencies) and
    return the file name."""
    scene = build_scene(bl, elements, beams, maxRays)
    html = _HTML.format(title=scene['title'],
                        scene_json=json.dumps(scene))
    with open(fileName, 'w') as f:
        f.write(html)
    return fileName


_SCAN_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ margin:0; background:#101018; color:#ddd;
        font:13px sans-serif; overflow:hidden }}
 #hud {{ position:absolute; left:10px; top:8px; pointer-events:none }}
 #bar {{ position:absolute; left:10px; bottom:10px; right:10px;
        display:flex; gap:10px; align-items:center }}
 #bar input[type=range] {{ flex:1 }}
 #bar button {{ background:#223; color:#ddd; border:1px solid #555;
        padding:2px 14px; cursor:pointer }}
 #frame {{ min-width:140px; color:#fc6; font-family:monospace }}
 canvas {{ display:block }}
</style></head><body>
<div id="hud">{title} &mdash; drag: orbit &middot; wheel: zoom &middot;
 shift-drag: pan</div>
<canvas id="c"></canvas>
<div id="bar"><button id="play">&#9654;</button>
 <input type="range" id="pos" min="0" max="{nmax}" value="0" step="1">
 <span id="frame"></span></div>
<script>
const SCENES = {scenes_json};
const LABELS = {labels_json};
let IDX = 0;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function resize() {{ W = cv.width = innerWidth;
  H = cv.height = innerHeight; }} resize(); onresize = () =>
  {{ resize(); draw(); }};
let mn=[1e30,1e30,1e30], mx=[-1e30,-1e30,-1e30];
function acc(p) {{ for (let k=0;k<3;k++) {{
  mn[k]=Math.min(mn[k],p[k]); mx[k]=Math.max(mx[k],p[k]); }} }}
SCENES.forEach(S => {{
  S.elements.forEach(e=>e.lines.forEach(l=>l.forEach(acc)));
  S.segments.forEach(s=>s.p.forEach(pr=>pr.forEach(acc))); }});
const ctr=[0,1,2].map(k=>(mn[k]+mx[k])/2);
const span=Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2],1e-9);
let yaw=0.6, pit=0.35, zoom=0.9/span, panX=0, panY=0;
function proj(p) {{
  const x=p[0]-ctr[0], y=p[1]-ctr[1], z=p[2]-ctr[2];
  const cy=Math.cos(yaw), sy=Math.sin(yaw);
  const cp=Math.cos(pit), sp=Math.sin(pit);
  const X = cy*y - sy*x;
  const Y0 = cy*x + sy*y;
  const Y = cp*z - sp*Y0;
  return [W/2 + (X*zoom)*W*0.9 + panX, H/2 - (Y*zoom)*W*0.9 + panY];
}}
function draw() {{
  const SCENE = SCENES[IDX];
  document.getElementById('frame').textContent = LABELS[IDX];
  document.getElementById('pos').value = IDX;
  ctx.clearRect(0,0,W,H);
  SCENE.segments.forEach(s => {{
    for (let i=0;i<s.p.length;i++) {{
      const a=proj(s.p[i][0]), b=proj(s.p[i][1]), c=s.rgb[i];
      ctx.strokeStyle = `rgba(${{255*c[0]|0}},${{255*c[1]|0}},` +
        `${{255*c[2]|0}},${{s.good[i] ? 0.55 : 0.08}})`;
      ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);
      ctx.stroke();
    }}
  }});
  SCENE.elements.forEach(e => {{
    ctx.strokeStyle = e.color; ctx.globalAlpha = 0.9;
    e.lines.forEach(l => {{
      ctx.beginPath();
      l.forEach((p,i) => {{ const q=proj(p);
        i ? ctx.lineTo(q[0],q[1]) : ctx.moveTo(q[0],q[1]); }});
      ctx.stroke();
    }});
    const q = proj(e.lines[0][0]);
    ctx.fillStyle = e.color; ctx.fillText(e.name, q[0]+4, q[1]-4);
    ctx.globalAlpha = 1;
  }});
}}
let drag=null;
cv.onmousedown = e => drag=[e.clientX,e.clientY,e.shiftKey];
onmouseup = () => drag=null;
onmousemove = e => {{ if (!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if (drag[2]) {{ panX+=dx; panY+=dy; }}
  else {{ yaw+=dx*0.008; pit+=dy*0.008; }}
  drag=[e.clientX,e.clientY,drag[2]]; draw(); }};
cv.onwheel = e => {{ zoom *= Math.exp(-e.deltaY*0.001); draw();
  e.preventDefault(); }};
document.getElementById('pos').oninput = e => {{
  IDX = +e.target.value; draw(); }};
let timer = null;
document.getElementById('play').onclick = e => {{
  if (timer) {{ clearInterval(timer); timer = null;
    e.target.innerHTML = '&#9654;'; return; }}
  e.target.innerHTML = '&#9208;';
  timer = setInterval(() => {{
    IDX = (IDX + 1) % SCENES.length; draw(); }}, 400);
}};
draw();
</script></body></html>
"""


def build_scan_frames(bl, flow, element, param, values,
                      maxRays=_MAX_RAYS):
    """Replay the recorded *flow* for each value of ``element.param`` and
    return [(label, scene)] frames: the data behind the scan player
    (capability of the reference's xrtGlow scan player,
    gui/xrtGlow/widgets/scan.py).  Each value is set in the form of the
    parameter it replaces (a tensor of its dtype on its device, a tuple or
    a number)."""
    from .server import _value_like
    frames = []
    el0 = bl[element]
    cur = getattr(el0, param)
    for v in values:
        new = el0.replace(**{param: _value_like(cur, v)})
        results = flow.replay(replace={element: new})
        beams = {}
        for key, val in results.items():
            if key.startswith('~'):
                continue
            b = val[0] if isinstance(val, tuple) else val
            if hasattr(b, 'state'):
                beams[key] = b
        elements = dict(bl._elements)
        elements[element] = new
        scene = build_scene(elements=elements, beams=beams,
                            maxRays=maxRays)
        frames.append((f'{element}.{param} = {float(v):.6g}', scene))
    return frames


def export_scan_html(frames, fileName='glow_scan.html',
                     title='scan') -> str:
    """Write a standalone scan-player HTML (slider + play button stepping
    through the *frames* from :func:`build_scan_frames`)."""
    labels = [lb for lb, _ in frames]
    scenes = [sc for _, sc in frames]
    html = _SCAN_HTML.format(
        title=title, nmax=len(frames) - 1,
        scenes_json=json.dumps(scenes),
        labels_json=json.dumps(labels))
    with open(fileName, 'w') as f:
        f.write(html)
    return fileName


def export_png(bl=None, elements=None, beams=None, fileName='glow.png',
               maxRays=_MAX_RAYS, elev=20, azim=-60) -> str:
    """Static matplotlib 3D render of the same scene (matplotlib is
    imported here, not with the module)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    scene = build_scene(bl, elements, beams, maxRays)
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(projection='3d')
    for seg in scene['segments']:
        for pr, col, good in zip(seg['p'], seg['rgb'], seg['good']):
            (x1, y1, z1), (x2, y2, z2) = pr
            ax.plot([x1, x2], [y1, y2], [z1, z2], color=tuple(col),
                    alpha=0.5 if good else 0.06, lw=0.6)
    for e in scene['elements']:
        for line in e['lines']:
            arr = np.asarray(line)
            ax.plot(arr[:, 0], arr[:, 1], arr[:, 2], color=e['color'],
                    lw=0.8)
        p0 = e['lines'][0][0]
        ax.text(p0[0], p0[1], p0[2], e['name'], fontsize=7,
                color=e['color'])
    ax.set_xlabel('x [mm]')
    ax.set_ylabel('y [mm]')
    ax.set_zlabel('z [mm]')
    ax.view_init(elev=elev, azim=azim)
    fig.tight_layout()
    fig.savefig(fileName, dpi=130)
    plt.close(fig)
    return fileName
