"""One replica's step shared over the ranks of a process group: the
"atoms" axis of parallel/mesh.py (counterpart of atom_sharding and
make_atom_sharded_step / _scan of reactive_pb_nn_md_tpu/parallel/
ensemble.py, where GSPMD shards the step by annotation).

The decomposition is explicit.  Every term of the step whose cost grows
with the atom count N is split over the ranks, and every other term is
computed the same way on every rank:

  split   the inter-molecular real-space sweep by home cells (kernel A's
          range launch; A' and A'' sweep every cell and keep their
          cells' rows) or, without a cell grid, by the half list's rows;
          the intra-molecular nonbonded and bonded terms by molecules;
          the Ewald self term and the base PME charge spread by atoms;
  shared  the neighbor lists, the integrator, the EVB enumeration, the
          changed-molecule set U and its rows, the per-state deltas,
          kernel C, the couplings, the ground state (kernel E), the FFT.

Positions, velocities and the whole MDState stay replicated on every
rank (the JAX layout keeps x sharded between chunks; here nothing of the
state is split, only the work of the force evaluation).  This is exact
because the state-independent bulk (energy_no_recip) and the base
reciprocal energy enter every EVB diagonal alike, so with c normalised
c^T H c = bulk + c^T H' c: the bulk's share of each rank sums over the
ranks, and the EVB part on U costs the same at any N.

The collectives of one step, each an all-reduce over the group
(collective_summary counts them by name):

  grid    sum of the base grid Q0 before the FFT (e0 and the per-state
          contraction are quadratic in it);
  energy  sum of the bulk's five scalars (elec, vdw, bond, angle,
          dihedral);
  force   sum of the (N, 3) forces;
  flags   max of the step's flags (capacities, the small tier's
          overflow, kernel E's failure), so every host decision taken
          from them is the same on every rank.

Forces are counted once.  The grid and energy sums pass the gradient
through unchanged in their backward (everything downstream of them is
the same on every rank, so summing it would count the reciprocal and
bulk forces `size` times): each rank's backward gives the gradient of
its own split share.  The shared terms read x through `shared`, whose
backward keeps the gradient on rank 0 only.  The force sum then adds
the split shares once each and the shared terms once.

A replica batch (md/integrators.py batched_md_scan: md_step under
torch.func.vmap) runs under a shard as one replica does: the shares are
static, so each kernel runs on this rank's share for all W replicas in
its one batched launch, and each collective is issued once a step for
the stacked (W, ...) tensor (_AllReduce's vmap rule), whatever W is.

A shared term recomputed on every rank takes the same bits on every rank
from the same inputs, on the CPU (gloo) and on the cards: the step sums
in a fixed order there too (the kernels, and kernel F for the gradients
of its gathers on positions, ops/kernels/segment_sum.py).
"""

from collections import Counter

import torch
import torch.distributed as dist

# collectives issued, by name (ops/kernels/_build.py keeps the counter
# beside the launches; a CUDA graph's replay adds what its capture
# counted, md/graphs.py)
from ..ops.kernels._build import collectives
# the kind of each named collective
KIND = {"grid": "all_reduce(sum)", "energy": "all_reduce(sum)",
        "force": "all_reduce(sum)", "flags": "all_reduce(max)"}
# the collectives of one step, by name: each once, batched or not
STEP_COLLECTIVES = dict.fromkeys(KIND, 1)


def split(n, size, rank):
    """(lo, hi) of rank's contiguous share of n items over size ranks
    (need not divide: the first ranks take one item fewer)."""
    return n * rank // size, n * (rank + 1) // size


def _all_reduce(t, group, op, name):
    """t reduced by `op` over the ranks of `group` into a new contiguous
    tensor: one collective, counted under `name`."""
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    collectives[name] += 1
    return out


class _AllReduce(torch.autograd.Function):
    """_all_reduce with the gradient passed through unchanged (a sum's;
    the force and flag reductions take none).  Under a replica batch
    (torch.func.vmap, with torch.func.grad inside it) the vmap rule
    reduces the whole stacked (W, ...) tensor in ONE collective: every
    rank of the group stacks its batch alike, so the elements meet."""

    @staticmethod
    def forward(t, group, op, name):
        return _all_reduce(t, group, op, name)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None

    @staticmethod
    def vmap(info, in_dims, t, group, op, name):
        return _all_reduce(t, group, op, name), in_dims[0]


class _RootGrad(torch.autograd.Function):
    """Identity forward; the gradient kept on the root rank only."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, root):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.root = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.root else torch.zeros_like(g)), None


class AtomShard:
    """Rank `rank` of `size` ranks of `group` (None: the default group)
    sharing one replica's step.  Its shares are static: they come from
    the System's counts alone (atoms, molecules, kernel A's cells), so a
    step that holds them stays capturable."""

    def __init__(self, group=None, rank=None, size=None):
        self.group = group
        self.rank = dist.get_rank(group) if rank is None else rank
        self.size = dist.get_world_size(group) if size is None else size
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} of {self.size}")

    def __repr__(self):
        return f"AtomShard(rank={self.rank}, size={self.size})"

    def atoms(self, n_atoms):
        """The slice of this rank's atoms."""
        return slice(*split(n_atoms, self.size, self.rank))

    def mols(self, n_mole):
        """The slice of this rank's molecules."""
        return slice(*split(n_mole, self.size, self.rank))

    def cells(self, cells):
        """(c0, c1): this rank's home cells of kernel A's grid `cells`."""
        nc1, nc2, nc3 = cells[:3]
        return split(nc1 * nc2 * nc3, self.size, self.rank)

    def shared(self, x):
        """x for a term every rank computes alike: its gradient stays on
        rank 0, so the force sum counts the term once."""
        return _RootGrad.apply(x, self.rank == 0)

    def sum(self, t, name):
        """t summed over the ranks, the gradient passed through."""
        return _AllReduce.apply(t, self.group, dist.ReduceOp.SUM, name)

    def sum_force(self, f):
        """The (N, 3) force shares summed over the ranks (no autograd)."""
        return _AllReduce.apply(f, self.group, dist.ReduceOp.SUM, "force")

    def any(self, flags):
        """The bool flags OR-ed over the ranks."""
        return _AllReduce.apply(flags.to(torch.int32), self.group,
                                dist.ReduceOp.MAX, "flags") != 0


def collective_summary(fn):
    """The collectives fn() issues (one step, say), by name and by kind:
    {"by_name": {"grid": 1, ...}, "by_kind": {"all_reduce(sum)": 3,
    ...}}.  The JAX package reads its summary from the compiled HLO;
    here the shard's wrappers count them."""
    before = Counter(collectives)
    fn()
    by_name = dict(Counter(collectives) - before)
    by_kind = Counter()
    for k, n in by_name.items():
        by_kind[KIND[k]] += n
    return {"by_name": by_name, "by_kind": dict(by_kind)}
