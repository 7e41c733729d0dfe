"""Ground eigenpair of the small symmetric EVB Hamiltonian (counterpart of
``ground_state_eigh`` in reactive_pb_nn_md_tpu/ops/ground_state.py).

For a CUDA tensor, kernel E (csrc/ground_state.cu): in fp64 in one
block, Householder tridiagonalization, Sturm-count multisection for
lambda_0 and inverse iteration for c_0, with no host synchronization, so
the MD step can be captured as a CUDA graph (torch.linalg.eigh checks its
info on the host).
For a CPU tensor, the plain version: eigh.  Both return c_0 with its
largest |c_i| positive; every consumer (c^T H c, c_i^2, argmax |c|) is
sign-invariant.  ground_state_op is a torch.library op whose batching
rule launches kernel E once for a whole replica batch (torch.func.vmap
over the MD step), one block a replica."""

import torch

from .kernels import _build


def fix_sign(c):
    """c with its largest |c_i| (the first such i) positive."""
    i = torch.argmax(c.abs())
    return torch.where(c.gather(0, i[None]) < 0, -c, c)


def ground_state_eigh(H):
    """(lambda_0, c_0) by eigh of H - H00 I: the plain version of kernel E.

    The diagonal carries the whole system energy (|H00| ~ 1e4 kJ/mol)
    while the physics lives in O(100) couplings and gaps; the shift moves
    the active block to gap scale.  The solve runs in float64 whatever
    H's dtype (an 80x80 eigh is cheap, and float32 eigh has lost the
    adiabatic mixing at a Zundel crossing); c comes back in H's dtype."""
    shift = H[0, 0].detach()
    Hs = (H.detach() - shift * torch.eye(H.shape[0], dtype=H.dtype,
                                         device=H.device)).to(torch.float64)
    w, v = torch.linalg.eigh(Hs)
    g = torch.argmin(w)[None]
    lam = w.gather(0, g)[0] + shift
    return lam.to(H.dtype), fix_sign(v.index_select(1, g)[:, 0]).to(H.dtype)


def max_rounds():
    """The most multisection rounds kernel E takes (GS_MAX_ROUNDS of
    csrc/ground_state.cu, read from the built library)."""
    return _build.function("ground_state_max_rounds", 0)()


def ground_state_cuda(H, nb=None):
    """Kernel E: (lambda_0 (), c_0 (S,), info () int32: the multisection
    rounds it took, 0..max_rounds(), or -1 when the interval did not close,
    the inverse-iteration residual ||(T - lambda_0 I) y||_inf exceeded
    16 nact eps ||T||_inf ||y||_inf (nact: the coupled states) or a value
    was not finite).  With nb, a batched launch of nb replicas' H (nb, S,
    S), one block each: (nb,), (nb, S), (nb,)."""
    S = H.shape[-1]
    f = H.dtype
    _build.require(H, f, (nb, S, S) if nb else (S, S), "H")
    lead = (nb,) if nb else ()
    # A in device memory where it does not fit in shared memory
    # (csrc/ground_state.cu decides)
    scratch = torch.empty(
        (nb or 1) * _build.function("ground_state_scratch", 0, 1)(S),
        dtype=torch.float64, device=H.device)
    lam = torch.empty(lead, dtype=f, device=H.device)
    c = torch.empty(lead + (S,), dtype=f, device=H.device)
    info = torch.empty(lead, dtype=torch.int32, device=H.device)
    fn = _build.function("ground_state_" + _build.suffix(f), 6, 3)
    _build.check(fn(H.data_ptr(), lam.data_ptr(), c.data_ptr(),
                    info.data_ptr(), scratch.data_ptr(),
                    _build.stream_ptr(H), S, nb or 1, S * S if nb else 0),
                 "E")
    _build.launches["E"] += 1
    return lam, c, info


@torch.library.custom_op(_build.OPS + "::ground_state", mutates_args=())
def ground_state_op(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """(lambda_0, c_0, info) of H: kernel E for a CUDA tensor, the plain
    eigh for a CPU one (info 0: eigh raises instead); a replica batch
    (vmap) launches E once for all replicas."""
    if H.is_cuda:
        return ground_state_cuda(H)
    lam, c = ground_state_eigh(H)
    return lam, c, torch.zeros((), dtype=torch.int32, device=H.device)


@ground_state_op.register_fake
def _(H):
    S = H.shape[-1]
    return H.new_empty(()), H.new_empty(S), H.new_empty((), dtype=torch.int32)


@ground_state_op.register_vmap
def _(info, in_dims, H):
    nb = info.batch_size
    H = H.movedim(in_dims[0], 0) if in_dims[0] is not None \
        else H.expand(nb, *H.shape)
    if H.is_cuda:
        return ground_state_cuda(H.contiguous(), nb), (0, 0, 0)
    out = [ground_state_op(H[i]) for i in range(nb)]
    return tuple(torch.stack(o) for o in zip(*out)), (0, 0, 0)


def ground_state(H):
    """(lambda_0, c_0, not_converged ()) of H, detached: kernel E for a
    CUDA tensor, the plain eigh for a CPU one (whose flag is always
    False: eigh raises instead)."""
    lam, c, info = ground_state_op(H.detach().contiguous())
    return lam, c, info < 0
