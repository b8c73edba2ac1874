#!/usr/bin/env python3
"""The port's forward Kirchhoff kernels against those of an earlier commit,
on one NVIDIA GPU, in one process: kernel B1 (recentred) and B2 (per-pair
double-float), and the per-pair double-float adjoint (B3 'fast' / 'exact'),
which shares B2's ``dd.cuh``.

    git archive <commit> xrt_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/torch_forward_compare.py build/parent/xrt_tpu_torch/csrc

The earlier sources must have the C entries ``kirchhoff_recentred_launch``
and ``kirchhoff_ddphase_launch`` of the one-thread-a-destination kernels
(sources as (keys, Ns padded to 256) rows) and the adjoint entries of
``csrc/kirchhoff_ddphase_bwd.cu``.  Prints:

* the card's name and power limit;
* for both sets of sources, every forward kernel's registers and spills
  (``nvcc -Xptxas -v``) and the instruction mix of its inner loop over the
  pairs (``cuobjdump -sass``: the innermost loop that holds more than 50
  float instructions), with the pairs that loop evaluates (one reciprocal
  ``MUFU.RCP`` a pair in B1, one ``MUFU.RSQ`` a pair in B2) and the
  instructions a pair;
* both designs in turns (earlier, current, current, earlier; median of 3 by
  CUDA events) at the main path's shapes with the smoke's random geometry:
  B1 mono at 2e5 x 2e5 and 65536 x 2e5, narrowband and poly at
  65536 x 2e5, B2 'fast' and 'exact' at 65536 x 2e5; the current kernel's
  sum of its source groups' partials and its scratch; the largest
  difference between the two designs, relative to each output's largest
  magnitude; the share of the operation bound of ``chip_smoke.py``;
* B3 'fast' / 'exact' at 65536 x 2e5, earlier and current in turns, and
  whether the two give the same bits.
"""
import collections
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
BUILD = ROOT / 'build' / 'compare'
P_ = ctypes.c_void_p
NVCC = '/usr/local/cuda/bin/nvcc'
CUOBJDUMP = '/usr/local/cuda/bin/cuobjdump'
EARLIER_ARGTYPES = {
    'kirchhoff_recentred': [ctypes.c_int, P_, ctypes.c_int, P_, ctypes.c_int,
                            P_, P_, P_],
    'kirchhoff_ddphase': [ctypes.c_int, P_, ctypes.c_int, P_, ctypes.c_int,
                          P_, P_]}
EARLIER_CHUNK = 256


def say(line):
    print(line, flush=True)


def build_earlier(csrc, name):
    """(library path, ptxas log) of an earlier source."""
    from xrt_tpu_torch.ops import _cuda
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / f'libearlier_{name}.so'
    r = subprocess.run([NVCC, *_cuda.NVCC_FLAGS, '-I', str(csrc), '-o',
                        str(so), str(csrc / f'{name}.cu')],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    return so, r.stdout + r.stderr


def demangle(fn):
    r = subprocess.run(['c++filt', fn], capture_output=True, text=True)
    return r.stdout.strip() or fn


INSN = re.compile(r'/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)'
                  r'(\.[A-Z0-9_.]+)?\s*([^;]*);')
FLOAT = ('FADD', 'FMUL', 'FFMA')


def inner_loops(so):
    """{kernel: Counter of the opcodes (MUFU and LDS with their first
    modifier) of its innermost loop holding more than 50 float
    instructions}."""
    txt = subprocess.run([CUOBJDUMP, '-sass', str(so)], capture_output=True,
                         text=True).stdout
    res = {}
    for part in re.split(r'\n\s*Function : ', txt)[1:]:
        fn = demangle(part.split('\n', 1)[0].strip())
        insns = []
        for m in INSN.finditer(part):
            op, mod = m.group(3), (m.group(4) or '')
            if op in ('MUFU', 'LDS'):
                op += mod.split('.')[1:2] and '.' + mod.split('.')[1] or ''
            insns.append((int(m.group(1), 16), op, m.group(5)))
        at = {a: i for i, (a, _, _) in enumerate(insns)}
        loops = []
        for i, (a, op, args) in enumerate(insns):
            t = re.search(r'0x([0-9a-f]+)', args) if op == 'BRA' else None
            if t and int(t.group(1), 16) < a and int(t.group(1), 16) in at:
                body = [o for _, o, _ in insns[at[int(t.group(1), 16)]:i + 1]]
                if sum(o in FLOAT for o in body) > 50:
                    loops.append(body)
        if loops:
            res[fn] = collections.Counter(min(loops, key=len))
    return res


def report_build(tag, so, log):
    """Registers, spills and the inner loop's mix of every forward kernel
    of one library."""
    import chip_smoke as cs
    for fn, regs, st, ld in cs.ptxas_rows(log):
        say(f'{tag} ptxas {demangle(fn)}: {regs} registers, spills {st} B '
            f'stored, {ld} B loaded')
    for fn, c in inner_loops(so).items():
        n = sum(c.values())
        pairs = c['MUFU.RSQ'] if 'ddphase' in str(so) or 'DD' in fn else \
            c['MUFU.RCP']
        top = ', '.join(f'{k} {v}' for k, v in c.most_common())
        per = f'{n / pairs:.1f} a pair' if pairs else 'pairs unknown'
        say(f'{tag} SASS inner loop of {fn}: {n} instructions for {pairs} '
            f'pairs ({per}; FADD+FMUL+FFMA {sum(c[k] for k in FLOAT)}): '
            f'{top}')


def main():
    import torch
    import chip_smoke as cs
    from xrt_tpu_torch.ops import _cuda, kirchhoff as tk
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    csrc = Path(sys.argv[1]).resolve()
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    say(f'card {card}')
    earlier = {}
    names = ('kirchhoff_recentred', 'kirchhoff_ddphase',
             'kirchhoff_ddphase_bwd')
    for name in names:
        so, log = build_earlier(csrc, name)
        report_build('earlier', so, log)
        earlier[name] = ctypes.CDLL(str(so))
    try:
        _cuda.build()
        current = True
    except RuntimeError as e:    # the earlier kernels are still measured
        say(f'current build failed: {e}')
        current = False
    for name in names if current else ():
        report_build('current', _cuda.library_path(name),
                     _cuda.build_log(name))

    def med(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        return statistics.median(cs.cuda_ms(fn)[0] for _ in range(reps))

    def old_forward(name, v, D, S, P):
        npad = (-S.shape[1]) % EARLIER_CHUNK
        if npad:
            S = torch.cat([S, S.new_zeros((S.shape[0], npad))], 1)
        S = S.contiguous()
        out = torch.empty((10, D.shape[1]), device='cuda')
        f = getattr(earlier[name], f'{name}_launch')
        f.argtypes = EARLIER_ARGTYPES[name]
        f.restype = ctypes.c_int
        st = P_(torch.cuda.current_stream().cuda_stream)
        if P is None:
            err = f(v, D.data_ptr(), D.shape[1], S.data_ptr(), S.shape[1],
                    out.data_ptr(), st)
        else:
            err = f(v, D.data_ptr(), D.shape[1], S.data_ptr(), S.shape[1],
                    P.data_ptr(), out.data_ptr(), st)
        _cuda.check(err, f'earlier {name}')
        return out

    def rel(a, b):
        return max(float((a[i] - b[i]).abs().max()) /
                   max(float(b[i].abs().max()), 1e-30)
                   for i in range(b.shape[0]))

    cases = [('mono', 200_000), ('mono', 65536), ('narrowband', 65536),
             ('poly', 65536), ('fast', 65536), ('exact', 65536)]
    Ns = 200_000
    for mode, Nd in cases:
        args = cs.kernel_case_args('mono' if mode == 'mono' else 'poly',
                                   Nd=Nd, Ns=Ns)
        scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
        name = f'kirchhoff_{scheme}'
        if scheme == 'recentred':
            cur = lambda: tk._launch_recentred(D, S, P, v)
        else:
            cur = lambda: tk._launch_ddphase(D, S, v)
        old = lambda: old_forward(name, v, D, S, P)
        key = f'{name}:{mode}'
        if not current:
            say(f'{key} {Nd} x {Ns}: earlier {med(old):.2f} / {med(old):.2f}'
                f' ms')
            continue
        t = [med(old), med(cur), med(cur), med(old)]
        diff = rel(cur(), old())
        ntile, ngroup = tk.forward_grid(Nd, tk.forward_sources(S).shape[0])
        part = torch.randn((ngroup, 10, Nd), device='cuda')
        red = med(lambda: tk._forward_reduce(name, part))
        extra = (f'; grid {ntile} x {ngroup}, the sum of the groups\' '
                 f'partials {red:.3f} ms, scratch '
                 f'{part.numel() * 4 / 2 ** 20:.1f} MiB')
        del part
        bound = ''
        if key in cs.OPS_PER_PAIR:
            bms, _ = cs.bound_ms(key, Nd, Ns)
            bound = (f'; operation bound {bms:.2f} ms: earlier at '
                     f'{bms / min(t[0], t[3]):.1%}, current at '
                     f'{bms / min(t[1], t[2]):.1%}')
        say(f'{key} {Nd} x {Ns}: earlier {t[0]:.2f} / {t[3]:.2f} ms, '
            f'current {t[1]:.2f} / {t[2]:.2f} ms, speed-up '
            f'{(t[0] + t[3]) / (t[1] + t[2]):.3f}; '
            f'{Nd * Ns / (min(t[1], t[2]) * 1e-3):.3e} pairs/s; largest '
            f'difference {diff:.2e}{bound}{extra}')

    # B3 'fast' / 'exact': the earlier library behind the same wrapper
    current_load = _cuda.load
    for mode in ('fast', 'exact') if current else ():
        args = cs.kernel_case_args('poly', Nd=65536, Ns=Ns)
        scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
        S = tk._pad_sources(S)
        G = torch.randn((10, 65536), device='cuda',
                        generator=torch.Generator('cuda').manual_seed(7))
        cur = lambda: tk._launch_ddphase_bwd(D, S, G, v)

        def old():
            _cuda.load = lambda name: earlier[name]
            try:
                return tk._launch_ddphase_bwd(D, S, G, v)
            finally:
                _cuda.load = current_load
        t = [med(old), med(cur), med(cur), med(old)]
        same = all(torch.equal(a, b) for a, b in zip(cur(), old()))
        say(f'kirchhoff_ddphase_bwd:{mode} 65536 x {Ns}: earlier {t[0]:.2f} '
            f'/ {t[3]:.2f} ms, current {t[1]:.2f} / {t[2]:.2f} ms; same '
            f'bits: {same}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
