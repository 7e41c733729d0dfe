"""Force-field .pmt parser.

Reads the reference's force-field parameter format
(initialize_routines.f90:281-430, 646-691):

  solute_species          -> name, charge, epsilon, sigma, freeze
  custom_sapt_parameters  -> name, A_ex A_el A_ind A_dhf, B, C6 C8 C10 C12
  cross_terms             -> itype jtype p1 p2 p3    (1-based type indices)
  pairtypes               -> name1 name2 C6 C12      (special 1-4 params)
"""

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

SAPT_EXP_INIT = 3.0  # initialize_routines.f90:289 (exp_init)


@dataclass
class RawForceField:
    names: List[str]
    charge: np.ndarray          # (T,)
    eps_sigma: np.ndarray       # (T, 2) as read (epsilon, sigma)
    freeze: np.ndarray          # (T,) int
    sapt: np.ndarray            # (T, 9) A_ex A_el A_ind A_dhf B C6 C8 C10 C12
    has_sapt: bool
    cross_terms: List[Tuple[int, int, float, float, float]]  # 0-based indices
    pairtypes_14: List[Tuple[str, str, float, float]]        # name1,name2,C6,C12

    @property
    def n_types(self):
        return len(self.names)

    def type_index(self, name: str) -> int:
        return self.names.index(name)


def read_ffpmt(path) -> RawForceField:
    with open(path) as f:
        lines = f.read().splitlines()

    names: List[str] = []
    charge, eps_sigma, freeze = [], [], []
    sapt = None
    has_sapt = False
    cross_terms = []
    pairtypes = []

    i = 0
    n_types = 0
    while i < len(lines):
        line = lines[i]
        if "solute_species" in line:
            i += 2  # skip the 'atom_type_parameters' header line
            n_types = int(lines[i].split()[0])
            for k in range(n_types):
                i += 1
                args = lines[i].split()
                # the reference reader (initialize_routines.f90:332-347) wants
                # exactly 5 fields (name charge eps sigma freeze); the shipped
                # example file has 6 -- accept both
                if len(args) not in (5, 6):
                    raise ValueError(
                        f"solute_species line needs 5(+1) fields "
                        f"(name charge eps sigma freeze): {lines[i]!r}")
                names.append(args[0][:5])
                charge.append(float(args[1]))
                eps_sigma.append((float(args[2]), float(args[3])))
                freeze.append(int(float(args[4])))
        elif "custom_sapt_parameters" in line:
            has_sapt = True
            sapt = np.zeros((n_types, 9))
            i += 1  # header line
            for k in range(n_types):
                i += 1
                args = lines[i].split()
                if len(args) != 10:
                    raise ValueError("custom_sapt_parameters line needs "
                                     "name + 9 params")
                sapt[k] = [float(v) for v in args[1:10]]
        elif "cross_terms" in line:
            i += 1
            n_cross = int(lines[i].split()[0])
            for k in range(n_cross):
                i += 1
                args = lines[i].split()
                it, jt = int(args[0]) - 1, int(args[1]) - 1
                p = [float(v) for v in args[2:5]]
                while len(p) < 3:
                    p.append(0.0)
                cross_terms.append((it, jt, p[0], p[1], p[2]))
        elif "pairtypes" in line:
            i += 1
            n_pairs = int(lines[i].split()[0])
            for k in range(n_pairs):
                i += 1
                args = lines[i].split()
                pairtypes.append((args[0][:5], args[1][:5],
                                  float(args[2]), float(args[3])))
        i += 1

    if sapt is None:
        sapt = np.zeros((n_types, 9))
        sapt[:, 4] = SAPT_EXP_INIT

    if len(set(names)) != len(names):
        raise ValueError("duplicate atom type in force-field file")

    return RawForceField(
        names=names, charge=np.asarray(charge), eps_sigma=np.asarray(eps_sigma),
        freeze=np.asarray(freeze, dtype=np.int32), sapt=sapt, has_sapt=has_sapt,
        cross_terms=cross_terms, pairtypes_14=pairtypes)


def compile_vdw_tables(ff: RawForceField, lj_comb_rule: str):
    """Build (T,T) vdw dispatch + parameter tables.

    Reproduces gen_param / combination_rule_cross_terms /
    gen_C12_C6_epsilon_sigma (initialize_routines.f90:448-634):

      vdw_type: 0 = LJ (params C12, C6), 1 = SAPT Buckingham
                (params A, B, C6, C8, C10, C12), -1 = none.
    """
    small = 1e-6
    T = ff.n_types
    vdw_type = np.full((T, T), -1, dtype=np.int32)
    params = np.zeros((T, T, 6))
    explicit = np.zeros((T, T), dtype=bool)

    eps = ff.eps_sigma[:, 0]
    sapt_B = ff.sapt[:, 4]
    sapt_A0 = ff.sapt[:, 0]

    # explicit cross terms
    for (it, jt, p1, p2, p3) in ff.cross_terms:
        if lj_comb_rule == "opls":
            # file order is C6, C12 -> store C12 first
            params[it, jt, 0] = params[jt, it, 0] = p2
            params[it, jt, 1] = params[jt, it, 1] = p1
        else:
            params[it, jt, :3] = params[jt, it, :3] = (p1, p2, p3)
        explicit[it, jt] = explicit[jt, it] = True
        vdw_type[it, jt] = vdw_type[jt, it] = 0

    def lj_diag_c12c6(i):
        e, s = ff.eps_sigma[i]
        return 4.0 * e * s ** 12, 4.0 * e * s ** 6

    for i in range(T):
        for j in range(T):
            if explicit[i, j]:
                vdw_type[i, j] = 0
                continue
            if eps[i] > small and eps[j] > small:
                vdw_type[i, j] = 0
                if lj_comb_rule == "opls":
                    c12i, c6i = lj_diag_c12c6(i)
                    c12j, c6j = lj_diag_c12c6(j)
                    params[i, j, 0] = np.sqrt(c12i * c12j)
                    params[i, j, 1] = np.sqrt(c6i * c6j)
                elif lj_comb_rule == "standard":
                    # Lorentz-Berthelot on eps/sigma then convert
                    e = np.sqrt(eps[i] * eps[j])
                    s = 0.5 * (ff.eps_sigma[i, 1] + ff.eps_sigma[j, 1])
                    params[i, j, 0] = 4.0 * e * s ** 12
                    params[i, j, 1] = 4.0 * e * s ** 6
                else:
                    raise ValueError(f"unknown lj_comb_rule {lj_comb_rule!r}")
            elif (i != j and sapt_B[i] > small and sapt_B[j] > small
                  and (sapt_A0[i] > small or sapt_A0[j] > small)) or \
                 (i == j and ff.sapt[i, 0] > small):
                # SAPT-FF combination (initialize_routines.f90:577-595)
                vdw_type[i, j] = 1
                a = np.sqrt(ff.sapt[i, :4] * ff.sapt[j, :4])
                params[i, j, 0] = a[0] - a[1] - a[2] - a[3]
                bi, bj = sapt_B[i], sapt_B[j]
                params[i, j, 1] = (bi + bj) * bi * bj / (bi ** 2 + bj ** 2)
                params[i, j, 2:6] = np.sqrt(ff.sapt[i, 5:9] * ff.sapt[j, 5:9])
            else:
                vdw_type[i, j] = -1

    # with 'standard' rule explicit cross terms are eps/sigma -> convert all LJ
    if lj_comb_rule == "standard":
        for i in range(T):
            for j in range(T):
                if vdw_type[i, j] == 0 and explicit[i, j]:
                    e, s = params[i, j, 0], params[i, j, 1]
                    params[i, j, 0] = 4.0 * e * s ** 12
                    params[i, j, 1] = 4.0 * e * s ** 6

    # special 1-4 table defaults to the standard table
    params_14 = params.copy()
    for (n1, n2, c6, c12) in ff.pairtypes_14:
        i, j = ff.type_index(n1), ff.type_index(n2)
        params_14[i, j, 0] = params_14[j, i, 0] = c12
        params_14[i, j, 1] = params_14[j, i, 1] = c6

    return vdw_type, params, params_14
