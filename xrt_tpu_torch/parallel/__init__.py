"""Several cards: rays and Kirchhoff destinations split over the ranks of a
``torch.distributed`` process group.

Port of the reference package's ``parallel/__init__.py``.  There one
controller drives a device mesh and runs one function per device with
sums and permutations between them.  Here every rank is a process that runs
the same program on its own card (SPMD): the caller initializes the process
group (``nccl`` on the cards, ``gloo`` on the CPU), :func:`make_mesh` wraps
it, and the functions below split the work by the rank.

* :func:`sharded_step` traces one pass on every rank with its own
  generator and returns the plots' histograms summed over ranks;
* :func:`kirchhoff_sharded`, :func:`kirchhoff_ring` and the generic
  :func:`dst_sharded_call` split the destinations of a Kirchhoff integral
  over the ranks: the sources replicated (no collective but the final
  gather), or with ``ring=True`` split too and sent on around the ring, one
  step per rank;
* :func:`sharded_trace` is the data-parallel form of any reduction of the
  traced beams, a loss and its gradient among them.

Sums over ranks are taken in rank order (an all-gather, then an ordered
sum) so that the totals do not depend on the order in which a transport
reduces.  Every collective goes through the :class:`Mesh`, which counts the
bytes it moves and, where the backend cannot address the card's memory
(``gloo`` with CUDA tensors), stages the buffer through the host.

Gradients.  A value every rank holds in full is *replicated*; a value
each rank holds a part of is *sharded*.  :meth:`Mesh.replicate` marks the
replicated inputs of a split computation: its backward sums their
cotangents over ranks (each rank computed its part's).  :meth:`Mesh.gather`
and :meth:`Mesh.all_reduce` return replicated results: their backward keeps
this rank's own cotangent, since every rank holds the same loss.  So the
gradient on every rank equals the unsharded one, not ``world size`` times
it.  (``torch.distributed.nn.functional.all_gather`` sums the cotangents of
every rank in its backward, which with a replicated loss gives ``world
size`` times the gradient; hence these functions.)
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .. import config


class Mesh:
    """A process group, this rank's place in it and its device, with the
    collectives the split computations use.  ``bytes_moved`` counts the
    bytes this rank received from the others, ``host_bytes`` those it
    staged through the host."""

    def __init__(self, group, device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.ranks = dist.get_process_group_ranks(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device)
        #: gloo reads and writes host memory only
        self.host_staged = self.backend == 'gloo' and \
            self.device.type == 'cuda'
        self.bytes_moved = 0
        self.host_bytes = 0
        self.collectives = 0

    def __repr__(self):
        return (f'Mesh(rank {self.rank} of {self.size}, {self.backend}, '
                f'{self.device}'
                + (', staged through the host' if self.host_staged else '')
                + ')')

    # -- transport: byte buffers ------------------------------------------
    def _out(self, buf):
        if self.host_staged:
            self.host_bytes += buf.numel()
            return buf.cpu()
        return buf

    def _in(self, buf):
        if self.host_staged:
            self.host_bytes += buf.numel()
            return buf.to(self.device)
        return buf

    def _all_gather_bytes(self, buf):
        """Every rank's byte buffer (all of one length), in rank order."""
        self.collectives += 1
        src = self._out(buf)
        outs = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(outs, src, group=self.group)
        self.bytes_moved += (self.size - 1) * buf.numel()
        return [self._in(o) for o in outs]

    def _shift_bytes(self, buf, reverse=False):
        """The byte buffer of the previous rank on the ring (of the next one
        with *reverse*); this rank's goes the other way."""
        self.collectives += 1
        src = self._out(buf)
        dst = torch.empty_like(src)
        step = -1 if reverse else 1
        nxt = self.ranks[(self.rank + step) % self.size]
        prv = self.ranks[(self.rank - step) % self.size]
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, nxt, self.group),
            dist.P2POp(dist.irecv, dst, prv, self.group)])
        for r in reqs:
            r.wait()
        self.bytes_moved += buf.numel()
        return self._in(dst)

    # -- collectives on tensors (no autograd) -------------------------------
    def gather_list(self, tensors):
        """[per rank: its *tensors*], each rank's of the same shapes."""
        tensors = list(tensors)
        bufs = self._all_gather_bytes(_pack(tensors))
        return [_unpack(b, tensors) for b in bufs]

    def sum_ranks(self, tensors):
        """The *tensors* summed over ranks in rank order, in their own
        dtypes."""
        per_rank = self.gather_list(tensors)
        out = list(per_rank[0])
        for part in per_rank[1:]:
            out = [a + b for a, b in zip(out, part)]
        return out

    def shift(self, tensors, reverse=False):
        """The previous rank's *tensors* on the ring (the next rank's with
        *reverse*)."""
        tensors = list(tensors)
        return _unpack(self._shift_bytes(_pack(tensors), reverse), tensors)

    # -- collectives with gradients -----------------------------------------
    def replicate(self, *tensors):
        """*tensors* unchanged; in the backward pass their cotangents are
        summed over ranks (the inputs every rank holds in full)."""
        out = _Replicate.apply(self, *tensors)
        return out[0] if len(tensors) == 1 else out

    def all_reduce(self, *tensors):
        """*tensors* summed over ranks in rank order, replicated; the
        backward keeps this rank's cotangent."""
        out = _AllReduce.apply(self, *tensors)
        return out[0] if len(tensors) == 1 else out

    def gather(self, *tensors):
        """Each of *tensors* (this rank's part, of one length on every
        rank) concatenated over ranks along dimension 0, replicated; the
        backward keeps this rank's part of the cotangent."""
        out = _Gather.apply(self, *tensors)
        return out[0] if len(tensors) == 1 else out

    def ring_shift(self, *tensors):
        """:meth:`shift` with gradients: the cotangents go the other way
        around the ring."""
        return _RingShift.apply(self, *tensors)


def _real_view(t):
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def _pack(tensors):
    """The tensors' bytes, concatenated."""
    if not tensors:
        raise ValueError('nothing to send')
    return torch.cat([_real_view(t).reshape(-1).view(torch.uint8)
                      for t in tensors])


def _unpack(buf, like):
    """Tensors of the shapes and dtypes of *like* from *buf*."""
    out, pos = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        rv = _real_view(t) if t.is_complex() else t
        v = buf[pos:pos + n].clone().view(rv.dtype).reshape(rv.shape)
        out.append(torch.view_as_complex(v) if t.is_complex() else v)
        pos += n
    return out


def _zeros_for(grads, like):
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, like)]


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        ctx.save_for_backward(*tensors)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        like = ctx.saved_tensors
        need = [i for i, n in enumerate(ctx.needs_input_grad[1:]) if n]
        out = [None] * len(like)
        summed = ctx.mesh.sum_ranks(_zeros_for([grads[i] for i in need],
                                               [like[i] for i in need]))
        for i, g in zip(need, summed):
            out[i] = g
        return (None, *out)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *tensors):
        return tuple(mesh.sum_ranks(tensors))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        ctx.n = [t.shape[0] for t in tensors]
        per_rank = mesh.gather_list(tensors)
        return tuple(torch.cat([p[i] for p in per_rank])
                     for i in range(len(tensors)))

    @staticmethod
    def backward(ctx, *grads):
        r = ctx.mesh.rank
        return (None, *(None if g is None else g[r * n:(r + 1) * n]
                        for g, n in zip(grads, ctx.n)))


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        ctx.save_for_backward(*tensors)
        return tuple(mesh.shift(tensors))

    @staticmethod
    def backward(ctx, *grads):
        like = ctx.saved_tensors
        return (None, *ctx.mesh.shift(_zeros_for(grads, like),
                                      reverse=True))


def make_mesh(group=None, device=None) -> Mesh:
    """The :class:`Mesh` of *group* (the default group when None), which
    the caller has initialized (``torch.distributed.init_process_group``),
    as the reference's user initializes its distributed runtime.  *device*
    None is the card: ``cuda:LOCAL_RANK`` (torchrun's variable; the rank
    modulo the cards of the host without it), made the current device; a
    CUDA device without CUDA raises.  ``device='cpu'`` with ``gloo`` runs
    on the CPU."""
    if not dist.is_initialized():
        raise RuntimeError('make_mesh: initialize the process group first '
                           '(torch.distributed.init_process_group)')
    group = group or dist.group.WORLD
    if device is None:
        config.resolve_device(None)
        local = int(os.environ.get('LOCAL_RANK', dist.get_rank(group)))
        device = torch.device('cuda', local % torch.cuda.device_count())
    device = config.resolve_device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    return Mesh(group, device)


def split_generator(rng: torch.Generator, n, device=None):
    """*n* generators on *device* (the generator's own by default) seeded
    from *n* draws of *rng*, as the reference splits a key: every caller
    with the same *rng* state gets the same generators, and *rng* advances
    the same on every rank."""
    dev = torch.device(device) if device is not None else rng.device
    seeds = torch.randint(0, 2 ** 62, (n,), generator=rng,
                          device=rng.device, dtype=torch.int64).tolist()
    return [torch.Generator(dev).manual_seed(s) for s in seeds]


def _tree_tensors(tree, device, out):
    """The leaves of a histogram dict as tensors on *device*, in order
    (Python numbers become int64 / float64 tensors)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            _tree_tensors(v, device, out)
        elif isinstance(v, torch.Tensor):
            out.append(v if v.dtype != torch.bool else v.long())
        else:
            out.append(torch.tensor(
                v, dtype=torch.int64 if isinstance(v, int) else
                torch.float64, device=device))
    return out


def _tree_fill(tree, leaves):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out[k] = _tree_fill(v, leaves) if isinstance(v, dict) \
            else next(leaves)
    return out


def sharded_step(run_process, beamLine, plots, mesh: Mesh, rng):
    """One traced pass with the rays split over *mesh*: every rank runs
    ``run_process(beamLine, generator)`` with its own generator (of
    :func:`split_generator`, so *rng* advances the same on every rank) and
    fills the plots' histograms (on the card one ``hist_plot`` launch a
    plot); returns the per-plot histogram dicts summed over ranks in rank
    order, the same on every rank.  The rays of a pass are ``nrays`` times
    the world size, as in the reference's per-worker ``nrays``."""
    from ..runner import histogram_plot
    g = split_generator(rng, mesh.size, mesh.device)[mesh.rank]
    beams = run_process(beamLine, g)
    hists = [histogram_plot(plot, beams) for plot in plots]
    leaves = []
    for h in hists:
        _tree_tensors(h, mesh.device, leaves)
    summed = iter(mesh.sum_ranks(leaves))
    return [_tree_fill(h, summed) for h in hists]


def dst_sharded_call(mesh: Mesh, fn, dst_args, src_args, ring=False,
                     src_pad=None, acc_dtype=None, n_out=5):
    """``fn(*dst_args, *src_args) -> tuple of per-destination
    accumulators`` with the destinations split over the ranks of *mesh*.

    *fn* is an integral linear in its source samples whose *n_out* outputs
    are 1D over the destinations (a Kirchhoff kernel's flattened form, or
    the float64 plain path).  Destinations are padded with their last
    value to a multiple of the world size: zero padding would move the
    per-tile recentring reference points.  Each rank integrates its tile;
    the tiles are gathered (every rank gets the whole result) and clipped
    to the true length.

    - ``ring=False``: the sources are replicated; the final gather is the
      only collective.
    - ``ring=True``: the sources are split too; each rank integrates its
      tile against its own source shard, then against the shard it
      receives from the previous rank (``torch.distributed.
      batch_isend_irecv``), one step per rank.  *src_pad* is each source
      argument's pad rule: 'edge' for positions, k and normals, 'zero'
      (the default) for fields and weights, which then add nothing.

    *acc_dtype* casts each step's outputs before they are summed.  All of
    it is differentiable: the inputs' cotangents are summed over ranks."""
    from ..waves import pad1d_edge, pad1d_zero
    W, r = mesh.size, mesh.rank
    nd = len(dst_args)
    Nd = dst_args[0].shape[0]
    tile = -(-Nd // W)
    args = _Replicate.apply(mesh, *dst_args, *src_args)
    dsts = [pad1d_edge(v, tile * W - Nd)[r * tile:(r + 1) * tile]
            for v in args[:nd]]
    srcs = list(args[nd:])

    def step(shards):
        out = tuple(fn(*dsts, *shards))
        if len(out) != n_out:
            raise ValueError(f'fn returned {len(out)} accumulators, '
                             f'expected n_out={n_out}')
        return out if acc_dtype is None else \
            tuple(o.to(acc_dtype) for o in out)

    if not ring:
        acc = step(srcs)
    else:
        Ns = srcs[0].shape[0]
        chunk = -(-Ns // W)
        rules = src_pad or ['zero'] * len(srcs)
        shards = [(pad1d_edge if rule == 'edge' else pad1d_zero)(
            v, chunk * W - Ns)[r * chunk:(r + 1) * chunk]
            for v, rule in zip(srcs, rules)]
        acc = step(shards)
        for _ in range(W - 1):
            shards = mesh.ring_shift(*shards)
            acc = tuple(a + o for a, o in zip(acc, step(shards)))
    full = mesh.gather(*acc)
    if n_out == 1:
        full = (full,)
    return tuple(o[:Nd] for o in full)


def _kirchhoff_xla_flat(xd, yd, zd, xs, ys, zs, Es, Ep, k, n0, n1, n2, nl,
                        w):
    from ..waves import kirchhoff_integral_xla
    return kirchhoff_integral_xla(xd, yd, zd, xs, ys, zs, Es, Ep, k,
                                  [n0, n1, n2], nl, w)


#: pad rules of :func:`_kirchhoff_xla_flat`'s source arguments
XLA_SRC_PAD = ['edge'] * 3 + ['zero', 'zero', 'edge'] + ['edge'] * 3 + \
    ['edge', 'zero']


def _xla_args(xs, Es, Ep, k, n, nl, weights):
    nb = [torch.broadcast_to(torch.as_tensor(ni, dtype=xs.dtype,
                                             device=xs.device), xs.shape)
          for ni in n]
    return [Es, Ep, k, *nb, nl, weights]


def kirchhoff_sharded(mesh: Mesh, xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl,
                      weights):
    """The Kirchhoff integral (the plain path of
    :func:`~xrt_tpu_torch.waves.kirchhoff_integral_xla`) with the
    destinations split over *mesh* and the sources replicated: each rank
    integrates its destination tile against all sources; returns the five
    full-length accumulators on every rank."""
    return dst_sharded_call(
        mesh, _kirchhoff_xla_flat, [xd, yd, zd],
        [xs, ys, zs, *_xla_args(xs, Es, Ep, k, n, nl, weights)])


def kirchhoff_ring(mesh: Mesh, xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl,
                   weights):
    """The Kirchhoff integral with both ends split: the destination tiles
    stay on their ranks while the source shards go around the ring, each
    rank adding its tile's sums against every shard in turn (for source
    clouds too large to replicate)."""
    return dst_sharded_call(
        mesh, _kirchhoff_xla_flat, [xd, yd, zd],
        [xs, ys, zs, *_xla_args(xs, Es, Ep, k, n, nl, weights)],
        ring=True, src_pad=XLA_SRC_PAD)


def sharded_trace(run_process, beamLine, mesh: Mesh, rng, reduce_fn):
    """The general data-parallel trace: every rank traces with its own
    generator (:func:`split_generator`), then ``reduce_fn(beams, mesh)``
    turns this rank's beams into outputs reduced over ranks
    (:meth:`Mesh.all_reduce`).  Differentiable: a parameter every rank
    reads enters ``run_process`` through :meth:`Mesh.replicate`, so its
    gradient after a backward of a reduced loss is the sum over ranks, the
    same on every rank."""
    g = split_generator(rng, mesh.size, mesh.device)[mesh.rank]
    beams = run_process(beamLine, g)
    return reduce_fn(beams, mesh)


__all__ = ['Mesh', 'make_mesh', 'split_generator', 'sharded_step',
           'dst_sharded_call', 'kirchhoff_sharded', 'kirchhoff_ring',
           'sharded_trace']
