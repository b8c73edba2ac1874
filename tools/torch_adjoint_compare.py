#!/usr/bin/env python3
"""The port's adjoint kernels against those of an earlier commit, on one
NVIDIA GPU, in one process: kernel B3 (the Kirchhoff adjoints) and B4-bwd
(the histogram gather).

    git archive <commit> xrt_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/torch_adjoint_compare.py build/parent/xrt_tpu_torch/csrc

The earlier sources must have the C entries of the two-pass B3 (the dst and
src pass kernels ``bwd_dst_kernel`` / ``bwd_src_kernel``) and of
``hist2d_bwd_launch``.  Prints:

* the card's name and power limit;
* for both sets of sources, every adjoint kernel's registers and spills
  (``nvcc -Xptxas -v``) and the instruction mix of its inner loop over the
  pairs (``cuobjdump -sass``: the innermost backward branch that holds more
  than 100 float instructions);
* the earlier two passes timed apart, and both designs in turns (earlier,
  current, current, earlier; median of 3 by CUDA events), at the main
  path's shapes with the smoke's random geometry: recentred mono at
  2e5 x 2e5 and 65536 x 2e5, per-pair double-float 'fast' and 'exact' at
  65536 x 2e5; the current kernel's reduction of its partials and its
  scratch; the largest row difference between the two;
* the gather at 1e7 uniform rays into 128 x 128 for k = 1 and 3, earlier,
  current and the advanced-indexing gather on prepared indices, against
  the bytes bound; earlier and current equal to the plain version;
* the gradient step of the smoke's phase 9 (2e5 samples per wave) with
  either adjoint, in turns, with its peak device memory.
"""
import collections
import ctypes
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
BUILD = ROOT / 'build' / 'compare'
P_ = ctypes.c_void_p
NVCC = '/usr/local/cuda/bin/nvcc'

# entries that launch one pass of the earlier two-pass B3, appended to its
# sources
PASS_ENTRY = {
    'kirchhoff_recentred_bwd': r'''
extern "C" int one_pass_of_two(int which, int variant, const float* dst,
    int nd, const float* src, int ns_pad, const float* params,
    const float* gout, float* ddst, float* dsrc, double* ppart,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = (nd + BLOCK - 1) / BLOCK;
#define ONE(V) if (which == 0) bwd_dst_kernel<V><<<nblk, BLOCK, 0, s>>>( \
      dst, nd, src, ns_pad, params, gout, ddst, ppart); \
  else bwd_src_kernel<V><<<ns_pad / BLOCK, BLOCK, 0, s>>>( \
      dst, nd, src, ns_pad, params, gout, dsrc);
  if (variant == 0) { ONE(0) }
  else if (variant == 1) { ONE(1) }
  else { ONE(2) }
  return static_cast<int>(cudaGetLastError());
}
''',
    'kirchhoff_ddphase_bwd': r'''
extern "C" int one_pass_of_two(int which, int variant, const float* dst,
    int nd, const float* src, int ns_pad, const float* params,
    const float* gout, float* ddst, float* dsrc, double* ppart,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ONE(V) if (which == 0) bwd_dst_kernel<V><<<(nd + BLOCK - 1) / BLOCK, \
      BLOCK, 0, s>>>(dst, nd, src, ns_pad, gout, ddst); \
  else bwd_src_kernel<V><<<ns_pad / BLOCK, BLOCK, 0, s>>>( \
      dst, nd, src, ns_pad, gout, dsrc);
  if (variant == 0) { ONE(0) } else { ONE(1) }
  return static_cast<int>(cudaGetLastError());
}
''',
}
ONE_PASS_ARGTYPES = [ctypes.c_int, ctypes.c_int, P_, ctypes.c_int, P_,
                     ctypes.c_int, P_, P_, P_, P_, P_, P_]

def say(line):
    print(line, flush=True)


def build_earlier(csrc, name, append=''):
    """(library, ptxas log) of an earlier source, with *append* added."""
    from xrt_tpu_torch.ops import _cuda
    BUILD.mkdir(parents=True, exist_ok=True)
    cu = BUILD / f'earlier_{name}.cu'
    cu.write_text((csrc / f'{name}.cu').read_text() + append)
    so = BUILD / f'libearlier_{name}.so'
    r = subprocess.run([NVCC, *_cuda.NVCC_FLAGS, '-I', str(csrc), '-o',
                        str(so), str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    return ctypes.CDLL(str(so)), so, r.stdout + r.stderr


def demangle(fn):
    r = subprocess.run(['c++filt', fn], capture_output=True, text=True)
    return r.stdout.strip() or fn


INSN = re.compile(r'/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)'
                  r'(\.[A-Z0-9_.]+)?\s*([^;]*);')
MIX = ('FADD', 'FMUL', 'FFMA', 'MUFU', 'FRND', 'F2I', 'LDS', 'SHFL', 'FSEL',
       'STS')


def inner_loops(so):
    """{kernel: (instructions, Counter of opcodes)} of each kernel's
    innermost loop holding more than 100 float instructions."""
    txt = subprocess.run(['/usr/local/cuda/bin/cuobjdump', '-sass', str(so)],
                         capture_output=True, text=True).stdout
    res = {}
    for part in re.split(r'\n\s*Function : ', txt)[1:]:
        fn = demangle(part.split('\n', 1)[0].strip())
        insns = [(int(m.group(1), 16), m.group(3), m.group(5))
                 for m in INSN.finditer(part)]
        at = {a: i for i, (a, _, _) in enumerate(insns)}
        loops = []
        for i, (a, op, args) in enumerate(insns):
            t = re.search(r'0x([0-9a-f]+)', args) if op == 'BRA' else None
            if t and int(t.group(1), 16) < a and int(t.group(1), 16) in at:
                body = [o for _, o, _ in insns[at[int(t.group(1), 16)]:i + 1]]
                if sum(o in ('FADD', 'FMUL', 'FFMA') for o in body) > 100:
                    loops.append(body)
        if loops:
            body = min(loops, key=len)
            res[fn] = (len(body), collections.Counter(body))
    return res


def report_build(tag, so, log):
    import chip_smoke as cs
    for fn, regs, st, ld in cs.ptxas_rows(log):
        if 'bwd' in fn or 'adjoint' in fn:
            say(f'{tag} ptxas {demangle(fn)}: {regs} registers, spills {st} '
                f'B stored, {ld} B loaded')
    for fn, (n, c) in inner_loops(so).items():
        mix = ', '.join(f'{k} {c[k]}' for k in MIX if c[k])
        say(f'{tag} SASS inner loop of {fn}: {n} instructions ({mix}, '
            f'other {n - sum(c[k] for k in MIX)})')


def main():
    import torch
    import chip_smoke as cs
    from xrt_tpu_torch import histogram as th
    from xrt_tpu_torch.ops import _cuda, kirchhoff as tk
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    csrc = Path(sys.argv[1]).resolve()
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    say(f'card {card}')
    _cuda.build()
    earlier = {}
    for name in ('kirchhoff_recentred_bwd', 'kirchhoff_ddphase_bwd'):
        lib, so, log = build_earlier(csrc, name, PASS_ENTRY[name])
        report_build('earlier', so, log)
        report_build('current', _cuda.library_path(name),
                     _cuda.build_log(name))
        f = lib.one_pass_of_two
        f.argtypes = ONE_PASS_ARGTYPES
        f.restype = ctypes.c_int
        earlier[name] = f

    def med(fn, reps=3, n=1):
        fn()
        torch.cuda.synchronize()
        return statistics.median(cs.cuda_ms(fn, n)[0] for _ in range(reps))

    def two_pass(scheme, v, D, S, P, G, which=(0, 1)):
        bD, bS = torch.empty_like(D), torch.empty_like(S)
        pp = torch.empty((-(-D.shape[1] // 128), 10), dtype=torch.float64,
                         device='cuda')
        st = P_(torch.cuda.current_stream().cuda_stream)
        for w in which:
            err = earlier[f'kirchhoff_{scheme}_bwd'](
                w, v, D.data_ptr(), D.shape[1], S.data_ptr(), S.shape[1],
                0 if P is None else P.data_ptr(), G.data_ptr(),
                bD.data_ptr(), bS.data_ptr(), pp.data_ptr(), st)
            _cuda.check(err, 'earlier adjoint')
        return bD, bS, (None if P is None else
                        pp.sum(dim=0).to(torch.float32))

    cases = [('mono', 200_000, 200_000), ('mono', 65536, 200_000),
             ('fast', 65536, 200_000), ('exact', 65536, 200_000)]
    for mode, Nd, Ns in cases:
        args = cs.kernel_case_args('mono' if mode == 'mono' else 'poly',
                                   Nd=Nd, Ns=Ns)
        scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
        S = tk._pad_sources(S)
        G = torch.randn((10, Nd), device='cuda',
                        generator=torch.Generator('cuda').manual_seed(7))
        dst_ms = med(lambda: two_pass(scheme, v, D, S, P, G, (0,)))
        src_ms = med(lambda: two_pass(scheme, v, D, S, P, G, (1,)))
        cur = lambda: tk._launch_adjoint(scheme, v, D, S, P, G)
        old = lambda: two_pass(scheme, v, D, S, P, G)
        t = [med(old), med(cur), med(cur), med(old)]
        diff = 0.0
        for a, b in zip(cur(), old()):
            if a is not None:
                diff = max(diff, max(
                    float((a[i] - b[i]).abs().max()) /
                    max(float(b[i].abs().max()), 1e-30)
                    for i in range(a.shape[0])))
        parts = tk._adjoint_pass(scheme, v, D, S, P, G)
        red = med(lambda: tk._adjoint_reduce(scheme, v, parts[0], parts[1],
                                             D, S))
        scratch = sum(p.numel() * p.element_size() for p in parts
                      if p is not None)
        del parts
        bms, _ = cs.bound_ms(f'kirchhoff_{scheme}_bwd:{mode}', Nd, Ns)
        say(f'B3 {mode} {Nd} x {Ns}: earlier dst pass {dst_ms:.2f} ms, src '
            f'pass {src_ms:.2f} ms; earlier (both) {t[0]:.2f} / {t[3]:.2f} '
            f'ms, current {t[1]:.2f} / {t[2]:.2f} ms (its reduction '
            f'{red:.3f} ms), speed-up {(t[0] + t[3]) / (t[1] + t[2]):.3f}; '
            f'bound {bms:.2f} ms: current at {bms / min(t[1:3]):.1%}; '
            f'largest row difference {diff:.2e}; scratch '
            f'{scratch / 2 ** 30:.3f} GiB')

    lib, so, log = build_earlier(csrc, 'hist2d')
    report_build('earlier', so, log)
    report_build('current', _cuda.library_path('hist2d'),
                 _cuda.build_log('hist2d'))
    gather = lib.hist2d_bwd_launch
    gather.argtypes = th._BWD_ARGTYPES
    gather.restype = ctypes.c_int
    for k in (1, 3):
        x, y, _, xb, yb, xl, yl = cs.hist_case('shared', k)
        g = torch.rand((yb, xb, k), device='cuda',
                       generator=torch.Generator('cuda').manual_seed(3))

        def old():
            out = torch.empty((x.shape[0], k), device='cuda')
            _cuda.check(gather(
                0, k, x.data_ptr(), y.data_ptr(), g.data_ptr(), x.shape[0],
                xl[0], xl[1] - xl[0], xb, yl[0], yl[1] - yl[0], yb,
                out.data_ptr(), P_(torch.cuda.current_stream().cuda_stream)),
                'earlier gather')
            return out
        cur = lambda: th.hist2d_bwd_kernel(x, y, g, xb, yb, xl, yl)
        fx, inx = th._bin_index(x, xl, xb)
        fy, iny = th._bin_index(y, yl, yb)
        flat = torch.where(inx & iny, fy * xb + fx,
                           torch.zeros_like(fx)).long()
        g2 = g.reshape(-1, k)
        idx = lambda: g2[flat]
        t = [med(old, 3, 5), med(cur, 3, 5), med(idx, 3, 5), med(cur, 3, 5),
             med(old, 3, 5)]
        same = torch.equal(cur(), old()) and torch.equal(
            cur(), th.hist2d_bwd_plain(x, y, g, xb, yb, xl, yl))
        bound = 1e3 * 4.0 * (x.shape[0] * (2 + k) + xb * yb * k) / \
            cs.PEAK_BYTES
        say(f'B4-bwd k={k}, {x.shape[0]} rays: earlier {t[0]:.4f} / '
            f'{t[4]:.4f} ms, current {t[1]:.4f} / {t[3]:.4f} ms, indexing '
            f'{t[2]:.4f} ms; bound {bound:.4f} ms: current at '
            f'{bound / min(t[1], t[3]):.1%}, indexing at {bound / t[2]:.1%};'
            f' all equal: {same}')

    # the gradient step of the smoke's phase 9 with either adjoint
    run, els = cs.build_chain(200_000, 256, torch.float32)
    ctx = cs.grad_context(run, els)
    current = tk._launch_recentred_bwd

    def step():
        leaves = cs.grad_leaves(torch.float32)
        loss = cs.chain_loss(run, els, ctx, *leaves)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return [float(g) for g in grads]

    def timed(use_earlier):
        if use_earlier:
            tk._launch_recentred_bwd = lambda D, S, P, G, v: two_pass(
                'recentred', v, D.contiguous(), S.contiguous(),
                P.contiguous(), G.contiguous())
        try:
            step()
            torch.cuda.reset_peak_memory_stats()
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                grads = step()
                ts.append(1e3 * (time.perf_counter() - t0))
            return statistics.median(ts), grads, \
                torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            tk._launch_recentred_bwd = current
    res = [timed(e) for e in (True, False, False, True)]
    diff = max(abs(a / b - 1) for a, b in zip(res[1][1], res[0][1]))
    say(f'gradient step, 2e5 samples per wave, 256 x 256 screen: earlier '
        f'{res[0][0]:.1f} / {res[3][0]:.1f} ms (peak {res[0][2]:.2f} GiB), '
        f'current {res[1][0]:.1f} / {res[2][0]:.1f} ms (peak '
        f'{res[1][2]:.2f} GiB); gradients differ by {diff:.2e}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
