"""End-to-end gradients of the port against the JAX package's and against
finite differences: the counterparts of ``tests/test_gradients.py``
(pitch, soft aperture, source divergence, the wave chain's waist),
``tests/test_trace_e2e.py::test_reflect_differentiable`` and the
double-slit gradient of ``tests/test_kirchhoff_grad.py``.

The JAX package's random streams cannot be reproduced in torch, so its
rays and receiver samples are dumped to numpy and injected into the port
(``interop.beam_from_numpy``, ``prepare_wave_on_*(samples=...)``).  Both
sides then run in float64 on the CPU, JAX eagerly under
``jax.disable_jit()``.  Each port gradient is held

* to the JAX gradient of the same function on the same rays: 1e-6
  relative (the same float64 operations; the intersection search ends on
  a slightly different bracket, which the two Newton steps polish away;
  measured <= 2e-9), and
* to a central finite difference at the reference's own tolerance
  (rtol 0.1 for the histogrammed pitch flux, 1e-4 for the soft aperture
  and the waist, 0.05 for the divergence, 1e-4 for the centroid).

The float32 double-slit gradient through ``diffract`` (the port's
autograd function on the CPU: plain forward, plain blocked backward)
against the JAX package's Pallas custom VJP in interpret mode (a
subprocess at XLA ``O0``): within 3%, the reference's own limit.
"""
import torch_harness  # noqa: F401

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import xrt_tpu.materials as jm
from xrt_tpu import waves as jw
from xrt_tpu.apertures import RectangularAperture as JSlit
from xrt_tpu.histogram import hist2d as j_hist2d
from xrt_tpu.oes import FlatMirror as JFlat, ToroidMirror as JToroid
from xrt_tpu.screens import Screen as JScreen
from xrt_tpu.sources import GaussianBeam as JGauss, \
    GeometricSource as JSource
from xrt_tpu_torch import interop, waves as tw
from xrt_tpu_torch.apertures import RectangularAperture
from xrt_tpu_torch.histogram import hist2d
from xrt_tpu_torch.materials import Material
from xrt_tpu_torch.oes import FlatMirror, ToroidMirror
from xrt_tpu_torch.physconsts import CH
from xrt_tpu_torch.screens import Screen
from xrt_tpu_torch.sources import GaussianBeam
from xrt_tpu_torch.wavechain import WaveChain

E0 = 9000.0
F64 = torch.float64
P, Q, PITCH = 10000.0, 2000.0, 4e-3
TOR = dict(center=(0, P, 0), R=2 * P * Q / (P + Q) / math.sin(PITCH),
           r=2 * P * Q / (P + Q) * math.sin(PITCH), limPhysX=(-20, 20),
           limPhysY=(-300, 300))
BEAM_FIELDS = ('x', 'y', 'z', 'a', 'b', 'c', 'E', 'path', 'Jss', 'Jpp',
               'Jsp', 'state')


def dump(beam):
    return {f: np.asarray(getattr(beam, f)) for f in BEAM_FIELDS}


def carried(beam):
    return interop.beam_from_numpy(dump(beam), device='cpu', dtype=F64)


def T(v):
    return torch.tensor(float(v), dtype=F64, requires_grad=True)


def value_and_grad(fn, v):
    t = T(v)
    val = fn(t)
    g, = torch.autograd.grad(val, [t])
    return float(val.detach()), float(g)


def central_fd(fn, v, h):
    with torch.no_grad():
        return (float(fn(torch.tensor(v + h, dtype=F64))) -
                float(fn(torch.tensor(v - h, dtype=F64)))) / (2 * h)


def test_grad_flux_vs_mirror_pitch_matches_jax_and_fd():
    """d(central flux)/d(pitch) through toroid (with the search) -> screen
    -> hist2d: the histogram's backward is the gather of its cotangent."""
    jsrc = JSource.create(nrays=4000, dx=0.1, dz=0.05, dxprime=2e-5,
                          dzprime=2e-5, energies=(E0,), distE='lines')
    jbeam = jsrc.shine(jax.random.PRNGKey(0))
    jmirror = JToroid.create(pitch=PITCH, material=jm.Material.create(
        'Rh', rho=12.41), **TOR)
    jscreen = JScreen.create(center=(0, P + Q, 2 * PITCH * Q))

    def jflux(pitch):
        glo, _ = jmirror.replace(pitch=pitch).reflect(jbeam)
        img = jscreen.expose(glo)
        w = jnp.where(img.state == 1, img.Jss + img.Jpp, 0.0)
        h = j_hist2d(img.x, img.z, w, 16, 16, (-2.0, 2.0), (-2.0, 2.0))
        wz = jnp.exp(-jnp.linspace(-2, 2, 16) ** 2 / 0.5)
        return jnp.sum(h * wz[:, None] * wz[None, :])
    with jax.disable_jit():
        jval, jg = jax.value_and_grad(jflux)(jnp.asarray(PITCH))

    beam = carried(jbeam)
    mirror = ToroidMirror.create(pitch=PITCH, material=Material.create(
        'Rh', rho=12.41, dtype=F64, device='cpu'), **TOR)
    screen = Screen.create(center=(0, P + Q, 2 * PITCH * Q))
    wz = torch.exp(-torch.linspace(-2, 2, 16, dtype=F64) ** 2 / 0.5)

    def flux(pitch):
        glo, _ = mirror.replace(pitch=pitch).reflect(beam)
        img = screen.expose(glo)
        w = torch.where(img.state == 1, img.Jss + img.Jpp, 0.0)
        h = hist2d(img.x, img.z, w, 16, 16, (-2.0, 2.0), (-2.0, 2.0))
        return torch.sum(h * wz[:, None] * wz[None, :])
    val, g = value_and_grad(flux, PITCH)
    assert val == pytest.approx(float(jval), rel=1e-9)
    assert g == pytest.approx(float(jg), rel=1e-6)
    fd = central_fd(flux, PITCH, 2e-6)
    assert np.isfinite(g) and abs(fd) > 0
    assert g == pytest.approx(fd, rel=0.1)


def test_grad_through_soft_aperture_matches_jax_and_fd():
    jsrc = JSource.create(nrays=3000, dx=0.0, dz=0.4, distz='flat',
                          dxprime=0.0, dzprime=0.0, distxprime=None,
                          distzprime=None, energies=(E0,), distE='lines')
    jbeam = jsrc.shine(jax.random.PRNGKey(1))
    kw = dict(center=(0, 1000.0, 0), opening=(-1.0, 1.0, -0.1, 0.1),
              softEdge=0.01)
    jslit = JSlit.create(**kw)

    def jflux(top):
        lo = jslit.replace(top=top).propagate(jbeam)
        return jnp.sum(jnp.where(lo.state > 0, lo.Jss + lo.Jpp, 0.0))
    with jax.disable_jit():
        jval, jg = jax.value_and_grad(jflux)(jnp.asarray(0.1))

    beam = carried(jbeam)
    slit = RectangularAperture.create(**kw)

    def flux(top):
        lo = slit.replace(top=top).propagate(beam)
        return torch.sum(torch.where(lo.state > 0, lo.Jss + lo.Jpp, 0.0))
    val, g = value_and_grad(flux, 0.1)
    assert val == pytest.approx(float(jval), rel=1e-12)
    assert g > 0 and g == pytest.approx(float(jg), rel=1e-9)
    assert g == pytest.approx(central_fd(flux, 0.1, 1e-5), rel=1e-4)
    Tr = slit.transmission(torch.zeros(3, dtype=F64),
                           torch.tensor([0.0, 0.1, 0.2], dtype=F64))
    assert Tr[0] > 0.99 and abs(float(Tr[1]) - 0.5) < 0.01 and Tr[2] < 0.01


def test_grad_wrt_source_divergence_matches_jax_and_fd():
    jsrc = JSource.create(nrays=2000, dx=0.1, dz=0.05, dxprime=2e-5,
                          dzprime=2e-5, energies=(E0,), distE='lines')
    jbeam = jsrc.shine(jax.random.PRNGKey(2))
    jmirror = JToroid.create(pitch=PITCH, material=jm.Material.create(
        'Rh', rho=12.41), **TOR)
    jscreen = JScreen.create(center=(0, P + Q, 2 * PITCH * Q))

    def jvar(scale):
        b = jbeam.replace(c=jbeam.c * scale)
        nrm = jnp.sqrt(b.a ** 2 + b.b ** 2 + b.c ** 2)
        b = b.replace(a=b.a / nrm, b=b.b / nrm, c=b.c / nrm)
        img = jscreen.expose(jmirror.reflect(b)[0])
        w = (img.state == 1).astype(img.z.dtype)
        zm = jnp.sum(img.z * w) / jnp.sum(w)
        return jnp.sum(w * (img.z - zm) ** 2) / jnp.sum(w)
    with jax.disable_jit():
        jval, jg = jax.value_and_grad(jvar)(jnp.asarray(1.0))

    beam = carried(jbeam)
    mirror = ToroidMirror.create(pitch=PITCH, material=Material.create(
        'Rh', rho=12.41, dtype=F64, device='cpu'), **TOR)
    screen = Screen.create(center=(0, P + Q, 2 * PITCH * Q))

    def var(scale):
        b = beam.replace(c=beam.c * scale)
        nrm = torch.sqrt(b.a ** 2 + b.b ** 2 + b.c ** 2)
        b = b.replace(a=b.a / nrm, b=b.b / nrm, c=b.c / nrm)
        img = screen.expose(mirror.reflect(b)[0])
        w = (img.state == 1).to(F64)
        zm = torch.sum(img.z * w) / torch.sum(w)
        return torch.sum(w * (img.z - zm) ** 2) / torch.sum(w)
    val, g = value_and_grad(var, 1.0)
    assert val == pytest.approx(float(jval), rel=1e-9)
    assert g == pytest.approx(float(jg), rel=1e-6)
    assert g == pytest.approx(central_fd(var, 1.0, 1e-3), rel=0.05)


def test_reflect_differentiable_centroid_vs_pitch():
    """d(screen centroid)/d(pitch) of a flat mirror is 2 q."""
    p, q, pitch = 10000.0, 5000.0, 4e-3
    jsrc = JSource.create(nrays=2000, dx=0.1, dz=0.05, dxprime=1e-5,
                          dzprime=1e-5, energies=(E0,), distE='lines')
    jbeam = jsrc.shine(jax.random.PRNGKey(23))
    kw = dict(center=(0, p, 0), pitch=0.0, limPhysX=(-10, 10),
              limPhysY=(-150, 150))
    jmirror, jscreen = JFlat.create(**kw), JScreen.create(center=(0, p + q,
                                                                  0))

    def jcentroid(pt):
        img = jscreen.expose(jmirror.replace(pitch=pt).reflect(jbeam)[0])
        w = img.state == 1
        return jnp.sum(jnp.where(w, img.z, 0.0)) / jnp.sum(w)
    with jax.disable_jit():
        jg = jax.grad(jcentroid)(jnp.asarray(pitch))

    beam = carried(jbeam)
    mirror, screen = FlatMirror.create(**kw), Screen.create(center=(0, p + q,
                                                                    0))

    def centroid(pt):
        img = screen.expose(mirror.replace(pitch=pt).reflect(beam)[0])
        w = img.state == 1
        return torch.sum(torch.where(w, img.z, 0.0)) / torch.sum(w)
    _, g = value_and_grad(centroid, pitch)
    assert g == pytest.approx(2 * q, rel=1e-4)
    assert g == pytest.approx(float(jg), rel=1e-9)


# ---- the wave path ---------------------------------------------------------

L_SCR = 5000.0
SLIT = dict(center=(0, 0, 0), opening=(-0.1, 0.1, -0.1, 0.1))
GB = dict(w0=0.05, distE='lines', energies=(E0,), polarization='horizontal')
ZS = np.linspace(-0.2, 0.2, 41)


@pytest.fixture(scope='module')
def wave_problem():
    """The slit and screen waves of the reference's waist test, the JAX
    samples injected into the port."""
    jslit, jscreen = JSlit.create(**SLIT), JScreen.create(center=(0, L_SCR,
                                                                  0))
    jgb = JGauss.create(**GB)
    jwS = jw.prepare_wave_on_aperture(jslit, jgb, 300,
                                      key=jax.random.PRNGKey(1))
    jwScr = jw.prepare_wave_on_screen(jscreen, jslit, np.asarray([0.0]), ZS)
    slit, screen = RectangularAperture.create(**SLIT), \
        Screen.create(center=(0, L_SCR, 0))
    gb = GaussianBeam.create(**GB)
    wS = tw.prepare_wave_on_aperture(
        slit, gb, 0, samples=(np.asarray(jwS.x), np.asarray(jwS.z)),
        dtype=F64, device='cpu')
    wScr = tw.prepare_wave_on_screen(screen, slit, np.asarray([0.0]), ZS,
                                     dtype=F64, device='cpu')
    return dict(j=(jgb, jwS, jwScr), t=(gb, wS, wScr))


def test_grad_through_kirchhoff_wave_chain_matches_jax_and_fd(wave_problem):
    """d(soft focal flux)/d(w0) through shine + the float64 Kirchhoff
    integral (checkpointed chunks under autograd)."""
    jgb, jwS, jwScr = wave_problem['j']
    gb, wS, wScr = wave_problem['t']

    def jpeak(w0):
        src = jgb.replace(w0=w0).shine(jax.random.PRNGKey(2), jwS,
                                       toGlobal=False)
        out = jw.diffract(src, jwScr)
        return jnp.sum((out.Jss + out.Jpp) *
                       jnp.exp(-(out.z / 0.05) ** 2))
    with jax.disable_jit():
        jval, jg = jax.value_and_grad(jpeak)(jnp.asarray(0.05))

    def peak(w0):
        src = gb.replace(w0=w0).shine(None, wS, toGlobal=False)
        out = tw.diffract(src, wScr)
        return torch.sum((out.Jss + out.Jpp) *
                         torch.exp(-(out.z / 0.05) ** 2))
    val, g = value_and_grad(peak, 0.05)
    assert val == pytest.approx(float(jval), rel=1e-9)
    assert abs(g) > 0 and g == pytest.approx(float(jg), rel=1e-6)
    assert g == pytest.approx(central_fd(peak, 0.05, 1e-5), rel=1e-4)


def test_source_beam_cotangents_match_jax(wave_problem):
    """The gradient with respect to the source beam itself (a pytree of
    cotangents in JAX, carried across by ``interop.cotangents_from_numpy``):
    field cotangents (complex: the conventions are conjugate) and source
    position cotangents."""
    jgb, jwS, jwScr = wave_problem['j']
    gb, wS, wScr = wave_problem['t']
    jsrc = jgb.shine(jax.random.PRNGKey(2), jwS, toGlobal=False)

    def jloss(src):
        out = jw.diffract(src, jwScr)
        return jnp.sum((out.Jss + out.Jpp) * jnp.exp(-(out.z / 0.05) ** 2))
    with jax.disable_jit():
        jct = jax.grad(jloss, allow_int=True)(jsrc)
    fields = ('x', 'y', 'z', 'Es', 'Ep')
    ref = interop.cotangents_from_numpy(
        {f: np.asarray(getattr(jct, f)) for f in fields}, device='cpu',
        dtype=F64)

    src = gb.shine(None, wS, toGlobal=False)
    leaves = {f: getattr(src, f).detach().clone().requires_grad_(True)
              for f in fields}
    out = tw.diffract(src.replace(**leaves), wScr)
    loss = torch.sum((out.Jss + out.Jpp) * torch.exp(-(out.z / 0.05) ** 2))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for f, g in zip(fields, grads):
        r = ref[f]
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= 1e-8 * scale, f
    assert float(ref['Es'].imag.abs().max()) > 0


def test_wavechain_run_is_differentiable_with_per_run_waves():
    """A chain built once: gradient with respect to the source waist
    (through ``run(waves=...)`` with the source replaced) and to a per-run
    shift of the screen samples, against finite differences, in float64
    on the CPU; and the linearized retargeting Jacobian of the screen's
    samples against a rebuilt geometry."""
    slit = RectangularAperture.create(**SLIT)
    screen = Screen.create(center=(0, L_SCR, 0))
    gb = GaussianBeam.create(**GB)
    chain = WaveChain(gb, nrays=200, fixedEnergy=E0).through_aperture(
        slit).to_screen(screen, np.asarray([0.0]), ZS)
    run = chain.build(torch.Generator().manual_seed(3), dtype=F64,
                      device='cpu')
    w0s, wScr = run.waves
    wgt = torch.exp(-(wScr.z / 0.05) ** 2)

    def loss(w0, dz):
        waves = (w0s.replace(fromOE=gb.replace(w0=w0)),
                 wScr.replace(zDiffr=wScr.zDiffr + dz))
        out, logs = run(waves=waves)
        return torch.sum((out.Jss + out.Jpp) * wgt) * torch.exp(-2 * logs)
    w0, dz = T(0.05), T(0.0)
    val = loss(w0, dz)
    g_w0, g_dz = torch.autograd.grad(val, [w0, dz])
    base, _ = run()
    assert float(val.detach()) == pytest.approx(
        float(torch.sum((base.Jss + base.Jpp) * wgt)), rel=1e-12)
    fd_w0 = central_fd(lambda v: loss(v, torch.zeros((), dtype=F64)), 0.05,
                       1e-5)
    # a step of 1e-5 mm: below it the float64 phase rounding (one ulp of
    # r is 4e-5 rad at k r = 2e11) drowns the difference, above it the
    # curvature does
    fd_dz = central_fd(lambda v: loss(torch.tensor(0.05, dtype=F64), v), 0.0,
                       1e-5)
    assert float(g_w0) == pytest.approx(fd_w0, rel=1e-4)
    assert float(g_dz) == pytest.approx(fd_dz, rel=2e-4)

    # retargeting: the screen samples in the frame of a pitched mirror
    mirror = FlatMirror.create(center=(0, 1000.0, 0), pitch=5e-3,
                               limPhysX=(-5, 5), limPhysY=(-60, 60))
    x, y, z = (np.zeros(3), np.zeros(3), np.array([-0.1, 0.0, 0.1]))
    J = tw._placement_jacobian(screen, mirror, x, y, z, vary='from')
    dp = 1e-5
    g0 = tw._frame_to_global64(screen, x, y, z)
    moved = np.stack(tw._to_fromOE_local64(
        mirror.replace(pitch=5e-3 + dp), *g0))
    base = np.stack(tw._to_fromOE_local64(mirror, *g0))
    assert np.abs(moved - (base + J * dp)).max() < 1e-6


JAX_DOUBLE_SLIT = r"""
import numpy as np
import jax, jax.numpy as jnp
from xrt_tpu.apertures import RectangularAperture
from xrt_tpu.screens import Screen
from xrt_tpu.waves import prepare_wave_on_screen, diffract, Wave

jax.config.update('jax_enable_x64', False)
dt, cdt = jnp.float32, jnp.complex64
zero = jnp.zeros((n,), dt)
slit = RectangularAperture.create(center=(0, 0, 0),
                                  opening=(-0.5, 0.5, -0.5, 0.5))
screen = Screen.create(center=(0, L, 0))
wave = prepare_wave_on_screen(screen, slit, np.asarray([0.0]), zs)

def peak(sepv, use_pallas):
    src = Wave(x=jnp.asarray(x_src, dt), y=zero, z=jnp.asarray(u, dt) * sepv,
               a=zero, b=jnp.ones((n,), dt), c=zero,
               E=jnp.full((n,), E0, dt), state=jnp.ones((n,), jnp.int32),
               path=zero, Jss=jnp.ones((n,), dt), Jpp=zero,
               Jsp=jnp.zeros((n,), cdt), Es=jnp.ones((n,), cdt),
               Ep=jnp.zeros((n,), cdt), area=jnp.asarray(1.0 * 2 * d, dt))
    out = diffract(src, wave, use_pallas=use_pallas)
    wgt = jnp.exp(-(jnp.asarray(zs, dt) / (0.5 * period)) ** 2)
    return jnp.sum((out.Jss + out.Jpp) * wgt) * 1e-4

s0 = jnp.asarray(1.0, dt)
vp, gp = jax.value_and_grad(lambda s: peak(s, True))(s0)
print('RESULT', float(vp), float(gp))
"""
DOUBLE_SLIT_SETUP = r"""
import numpy as np
E0 = 9000.0
d, sep, L = 0.05, 0.4, 10000.0
lam = 12398.419843320026 / E0 * 1e-7
n = 512
rng = np.random.default_rng(0)
u = np.concatenate([rng.uniform(-d/2, d/2, n//2) - 0.5,
                    rng.uniform(-d/2, d/2, n//2) + 0.5])
x_src = rng.uniform(-0.5, 0.5, n)
period = lam * L / sep
zs = np.linspace(-1.2 * period, 1.2 * period, 33)
"""


def test_grad_through_diffract_f32_double_slit_matches_jax(clean_env_runner):
    """The reference's double-slit case (fringe-peak flux against the slit
    separation) through the float32 ``diffract``: source-position
    cotangents of the recentred autograd function."""
    stdout, _ = clean_env_runner(DOUBLE_SLIT_SETUP + JAX_DOUBLE_SLIT,
                                 timeout=900, f32=True)
    jval, jg = (float(v) for v in stdout.split('RESULT')[1].split())
    ns = {}
    exec(DOUBLE_SLIT_SETUP, ns)
    assert ns['lam'] == pytest.approx(CH / E0 * 1e-7, rel=1e-9)
    n, d, zs, period = ns['n'], ns['d'], ns['zs'], ns['period']
    f32, c64 = torch.float32, torch.complex64
    slit = RectangularAperture.create(center=(0, 0, 0),
                                      opening=(-0.5, 0.5, -0.5, 0.5))
    screen = Screen.create(center=(0, ns['L'], 0))
    wave = tw.prepare_wave_on_screen(screen, slit, np.asarray([0.0]), zs,
                                     dtype=f32, device='cpu')
    zero = torch.zeros(n, dtype=f32)
    u = torch.tensor(ns['u'], dtype=f32)
    wgt = torch.exp(-(torch.tensor(zs, dtype=f32) / (0.5 * period)) ** 2)

    def peak(sepv):
        src = tw.Wave(
            x=torch.tensor(ns['x_src'], dtype=f32), y=zero, z=u * sepv,
            a=zero, b=torch.ones(n, dtype=f32), c=zero,
            E=torch.full((n,), E0, dtype=f32),
            state=torch.ones(n, dtype=torch.int32), path=zero,
            Jss=torch.ones(n, dtype=f32), Jpp=zero,
            Jsp=torch.zeros(n, dtype=c64), Es=torch.ones(n, dtype=c64),
            Ep=torch.zeros(n, dtype=c64),
            area=torch.tensor(1.0 * 2 * d, dtype=f32))
        out = tw.diffract(src, wave)
        return torch.sum((out.Jss + out.Jpp) * wgt) * 1e-4
    s0 = torch.tensor(1.0, dtype=f32, requires_grad=True)
    val = peak(s0)
    g, = torch.autograd.grad(val, [s0])
    assert float(val.detach()) == pytest.approx(jval, rel=1e-3)
    assert abs(float(g) - jg) < 0.03 * abs(jg), (float(g), jg)
    h = 1e-3
    with torch.no_grad():
        fd = (float(peak(torch.tensor(1.0 + h))) -
              float(peak(torch.tensor(1.0 - h)))) / (2 * h)
    assert abs(float(g) - fd) < 0.05 * abs(fd), (float(g), fd)


def test_elements_keep_tensors_and_python_numbers():
    """``create`` / ``replace`` keep a tensor that is passed in (with its
    graph) and leave a Python number a Python float; the host geometry of
    the samplers reads the detached value."""
    pitch = T(PITCH)
    mirror = ToroidMirror.create(center=(0, P, T(0.0)), pitch=pitch,
                                 R=(P, Q), r=T(50.0), limPhysX=(-20, 20),
                                 limPhysY=(-300, 300))
    assert mirror.pitch is pitch and mirror.r.requires_grad
    assert mirror.R.grad_fn is not None          # Coddington from the pitch
    assert isinstance(mirror.center[0], float) and \
        mirror.center[2].requires_grad
    plain = ToroidMirror.create(center=(0, P, 0), pitch=PITCH, R=(P, Q),
                                r=50)
    assert all(isinstance(v, float) for v in
               (plain.pitch, plain.R, plain.r, *plain.center))
    assert isinstance(plain.replace(pitch=pitch).pitch, torch.Tensor)
    with pytest.raises(AttributeError):
        plain.replace(no_such_parameter=1.0)
    gb = GaussianBeam.create(w0=T(0.05))
    slit = RectangularAperture.create(opening=(-1.0, T(1.0), -0.1, 0.1))
    assert gb.w0.requires_grad and slit.right.requires_grad and \
        isinstance(slit.left, float)
    assert Screen.create(center=(0, T(1.0), 0)).center[1].requires_grad
    # host geometry: samplers accept the tensor-carrying elements
    w = tw.prepare_wave_on_oe(mirror, slit, (3, 3), dtype=F64, device='cpu')
    ref = tw.prepare_wave_on_oe(
        ToroidMirror.create(center=(0, P, 0), pitch=PITCH, R=(P, Q), r=50.0,
                            limPhysX=(-20, 20), limPhysY=(-300, 300)),
        RectangularAperture.create(opening=(-1.0, 1.0, -0.1, 0.1)), (3, 3),
        dtype=F64, device='cpu')
    assert not w.xDiffr.requires_grad
    assert torch.allclose(w.yDiffr, ref.yDiffr, rtol=0, atol=1e-9)
