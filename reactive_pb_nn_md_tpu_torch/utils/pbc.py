"""Periodic-boundary helpers (counterpart of reactive_pb_nn_md_tpu/utils/pbc.py).

Row convention: ``box[i]`` is the i-th lattice vector.  Lattice shifts are
detached, so autograd forces match the analytic reference forces.
"""

import torch


def box_volume(box):
    return torch.abs(torch.dot(box[0], torch.linalg.cross(box[1], box[2])))


def inv3x3(m):
    """Analytic 3x3 inverse (adjugate / det), the reference's formula."""
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e]),
        torch.stack([B, a * i - c * g, -(a * f - c * d)]),
        torch.stack([C, -(a * h - b * g), a * e - b * d]),
    ])
    return adj / det


def recip_vectors(box):
    """Reciprocal lattice vectors (rows), no 2*pi: kk[i] . box[j] = delta_ij."""
    return inv3x3(box).T


def xyz_to_frac(x, box):
    return x @ recip_vectors(box).T


def min_image_shift(dr, box):
    """Lattice translation S such that dr - S is the minimum image."""
    n = torch.floor(xyz_to_frac(dr, box) + 0.5)
    return n.detach() @ box


def min_image(dr, box):
    return dr - min_image_shift(dr, box)


def scaled_grid_coords(x, box, K, eps=1e-6):
    """Fractional coordinates scaled by K, folded to [0, K) and nudged off
    exact integers (create_scaled_direct_coordinates)."""
    u = xyz_to_frac(x, box) * K
    u = torch.where(u < 0.0, u + K, u)
    u = torch.where(u >= K, u - K, u)
    return torch.where(torch.abs(u - torch.round(u)) < eps, u + eps, u)
