"""Ground eigenpair of the small symmetric EVB Hamiltonian (counterpart of
``ground_state_eigh`` in reactive_pb_nn_md_tpu/ops/ground_state.py)."""

import torch


def ground_state_eigh(H):
    """(lambda_0, c_0) by eigh of H - H00 I.

    The diagonal carries the whole system energy (|H00| ~ 1e4 kJ/mol)
    while the physics lives in O(100) couplings and gaps; the shift moves
    the active block to gap scale.  The solve runs in float64 whatever
    H's dtype (an 80x80 eigh is cheap, and float32 eigh has lost the
    adiabatic mixing at a Zundel crossing); c comes back in H's dtype."""
    shift = H[0, 0].detach()
    Hs = (H.detach() - shift * torch.eye(H.shape[0], dtype=H.dtype,
                                         device=H.device)).to(torch.float64)
    w, v = torch.linalg.eigh(Hs)
    g = torch.argmin(w)
    return (w[g] + shift).to(H.dtype), v[:, g].to(H.dtype)
