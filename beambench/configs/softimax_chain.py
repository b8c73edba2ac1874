"""The SoftiMAX wave chain (xrt speed test 3) counted in the rays its source
shines: the driver of the configuration ``softimax_chain``.

Everything that builds, times and judges a run is the frozen driver of
``softimax`` (``configs/softimax.py``, loaded by name): its chain, its
window loop with its choice of the checked run, its check and its plain
reference (``references/softimax.py``).  This driver adds two things:

* before each chain run, ``xrt_tpu_torch.profiler.next_pass()``, so that
  the program's spans and counters (recorded while the run is traced) carry
  the run's own id;
* each completed run is one unit of ``kind='rays'`` with ``work`` the
  ``nrays`` samples the source shines in it, the units that
  ``rays_per_s`` and ``pass_p95_ms`` read.
"""
import harness

#: the frozen driver this one delegates to
FROZEN = harness.load_module('configs', 'softimax')


def setup(cfg, traffic, cell, seed, device):
    return FROZEN.setup(cfg, traffic, cell, seed, device)


def window(st, seconds, clock, trace):
    """The frozen window, with a new pass id before each chain run; each
    run a unit of the rays its source shines."""
    from xrt_tpu_torch import profiler
    chain = st.run_chain

    def run_chain(*args, **kwargs):
        profiler.next_pass()
        return chain(*args, **kwargs)
    st.run_chain = run_chain
    try:
        res = FROZEN.window(st, seconds, clock, trace)
    finally:
        st.run_chain = chain
    for u in res['units']:
        u.update(kind='rays', work=int(st.cfg['nrays']))
    return res


def free_program(st):
    FROZEN.free_program(st)


def check(st, seed, lowered=False):
    return FROZEN.check(st, seed, lowered=lowered)
