"""First-party SMILES writer: MolRecord graph -> SMILES string (port of
decompdiff_tpu/evaluation/smiles.py's `mol_to_smiles`; the valence helpers
come from evaluation/descriptors.py, as there). The result rows of the
sampling driver carry it (ref scripts/sample_diffusion_decomp.py:432
Chem.MolToSmiles); the SMILES parser is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from decompdiff_tpu_torch.evaluation.descriptors import (
    DEFAULT_VALENCES, _undirected, implicit_h_counts)

# atoms written without brackets, and their aromatic (lowercase) symbols
ORGANIC_SUBSET = ('Cl', 'Br', 'B', 'C', 'N', 'O', 'P', 'S', 'F', 'I')
AROMATIC_ORGANIC = ('b', 'c', 'n', 'o', 's', 'p')

SYMBOL_TO_Z = {
    'H': 1, 'He': 2, 'Li': 3, 'Be': 4, 'B': 5, 'C': 6, 'N': 7, 'O': 8,
    'F': 9, 'Ne': 10, 'Na': 11, 'Mg': 12, 'Al': 13, 'Si': 14, 'P': 15,
    'S': 16, 'Cl': 17, 'K': 19, 'Ca': 20, 'Mn': 25, 'Fe': 26, 'Co': 27,
    'Ni': 28, 'Cu': 29, 'Zn': 30, 'As': 33, 'Se': 34, 'Br': 35, 'I': 53,
}


class SmilesError(ValueError):
    pass


# --------------------------------------------------------------------------
# SMILES writer (canonical within this implementation)

Z_TO_SYMBOL = {z: s for s, z in SYMBOL_TO_Z.items()}
_ORGANIC_Z = {SYMBOL_TO_Z[s] for s in ORGANIC_SUBSET}
_AROMATIC_OK_Z = {SYMBOL_TO_Z[c.upper()] for c in AROMATIC_ORGANIC}


def _h_counts_for(record) -> np.ndarray:
    h = implicit_h_counts(record.element, _undirected(record),
                          record.charges)
    for idx, cnt in (record.props or {}).get('explicit_h', {}).items():
        h[idx] = cnt
    return h


def canonical_ranks(record) -> List[int]:
    """Deterministic canonical atom ranks: WL-style refinement over
    (element, aromatic, charge, degree, H) seeds with tie-breaking, so
    isomorphic graphs (any atom order) get identical ranks."""
    n = record.num_atoms
    bonds = _undirected(record)
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for (a, b), o in bonds.items():
        adj[a].append((b, o))
        adj[b].append((a, o))
    h = _h_counts_for(record)
    charges = (record.charges if record.charges is not None
               else np.zeros(n, np.int64))
    seeds = [(int(record.element[i]), bool(record.aromatic[i]),
              int(charges[i]), len(adj[i]), int(h[i])) for i in range(n)]
    order = sorted(range(n), key=lambda i: seeds[i])
    ranks = [0] * n
    for pos, i in enumerate(order):
        ranks[i] = (ranks[order[pos - 1]]
                    if pos and seeds[i] == seeds[order[pos - 1]]
                    else pos)

    def refine(ranks):
        while True:
            keys = [(ranks[i],
                     tuple(sorted((o, ranks[j]) for j, o in adj[i])))
                    for i in range(n)]
            order = sorted(range(n), key=lambda i: keys[i])
            new = [0] * n
            for pos, i in enumerate(order):
                new[i] = (new[order[pos - 1]]
                          if pos and keys[i] == keys[order[pos - 1]]
                          else pos)
            if new == ranks:
                return ranks
            ranks = new

    ranks = refine(ranks)

    # Break remaining WL ties canonically: branch over every member of the
    # smallest tied class, refine each branch, recurse, and keep the branch
    # whose fully-resolved labeled-graph certificate is minimal. The
    # candidate set is permutation-invariant, so the minimum is too —
    # including for WL-indistinguishable NON-automorphic atoms (regular
    # graphs like the Frucht cage), where a fixed-member tie-break would be
    # input-order dependent. Branch count ~ automorphism-group order for
    # symmetric molecules; `budget` caps pathological cases (beyond it the
    # result is still deterministic for a fixed atom order, just not
    # guaranteed order-independent).
    def certificate(rk):
        atoms = tuple(sorted((rk[i],) + tuple(seeds[i]) for i in range(n)))
        bnds = tuple(sorted(
            (min(rk[a], rk[b]), max(rk[a], rk[b]), o)
            for (a, b), o in bonds.items()))
        return (atoms, bnds)

    budget = [3000]

    def resolve(rk):
        tied = {}
        for i, r in enumerate(rk):
            tied.setdefault(r, []).append(i)
        classes = sorted(r for r, ms in tied.items() if len(ms) > 1)
        if not classes:
            return certificate(rk), rk
        tr = classes[0]
        best = None
        for i in tied[tr]:
            if budget[0] <= 0 and best is not None:
                break
            budget[0] -= 1
            bumped = [r + 1 if (r > tr or (r == tr and j != i)) else r
                      for j, r in enumerate(rk)]
            cert, full = resolve(refine(bumped))
            if best is None or cert < best[0]:
                best = (cert, full)
        return best

    if len(set(ranks)) < n:
        ranks = resolve(ranks)[1]
    return ranks


def mol_to_smiles(record, canonical: bool = True) -> str:
    """Write a MolRecord as SMILES (role of ref
    scripts/sample_diffusion_decomp.py:432 Chem.MolToSmiles on result
    rows). `canonical=True` gives an atom-order-independent string —
    canonical for THIS writer, not byte-identical to RDKit's."""
    n = record.num_atoms
    if n == 0:
        return ''
    bonds = _undirected(record)
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for (a, b), o in bonds.items():
        adj[a].append((b, o))
        adj[b].append((a, o))
    ranks = canonical_ranks(record) if canonical else list(range(n))
    h = _h_counts_for(record)
    charges = (record.charges if record.charges is not None
               else np.zeros(n, np.int64))
    aromatic = np.asarray(record.aromatic, bool)

    def bare_h_roundtrip(i) -> int:
        """H count the parser's valence model would assign on re-read."""
        s = 0.0
        for _, o in adj[i]:
            s += 1.5 if o == 4 else float(o)
        s = int(round(s))
        q = int(charges[i])
        for v in DEFAULT_VALENCES.get(int(record.element[i]), (s,)):
            if v + q >= s:
                return v + q - s
        return 0

    def atom_token(i) -> str:
        z = int(record.element[i])
        arom = bool(aromatic[i])
        q = int(charges[i])
        if z == 0:
            return '*'
        sym = Z_TO_SYMBOL.get(z)
        if sym is None:
            raise SmilesError(f'no symbol for element {z}')
        # plain (bracket-free) only when re-reading reproduces the graph:
        # organic subset, no charge, valence-model H matches, and the
        # aromatic flag is expressible as a lowercase symbol
        plain_ok = (z in _ORGANIC_Z and q == 0
                    and int(h[i]) == bare_h_roundtrip(i)
                    and not (arom and z not in _AROMATIC_OK_Z))
        if plain_ok:
            return sym.lower() if arom else sym
        parts = [sym.lower() if (arom and z in _AROMATIC_OK_Z) else sym]
        hc = int(h[i])
        if hc == 1:
            parts.append('H')
        elif hc > 1:
            parts.append(f'H{hc}')
        if q == 1:
            parts.append('+')
        elif q == -1:
            parts.append('-')
        elif q > 1:
            parts.append(f'+{q}')
        elif q < -1:
            parts.append(f'-{-q}')
        return '[' + ''.join(parts) + ']'

    def written_aromatic(i) -> bool:
        # aromaticity survives the roundtrip only when the symbol is
        # written lowercase (organic aromatic subset); e.g. an
        # aromatic-flagged halogen is emitted as [F] and re-reads plain
        return bool(aromatic[i]) and int(record.element[i]) in _AROMATIC_OK_Z

    def bond_token(i, j, o) -> str:
        both_arom = written_aromatic(i) and written_aromatic(j)
        if o == 1:
            return '-' if both_arom else ''
        if o == 2:
            return '='
        if o == 3:
            return '#'
        if o == 4:
            return '' if both_arom else ':'
        raise SmilesError(f'bad bond order {o}')

    # DFS per component in canonical order; ring-closure bonds get digits
    visited = [False] * n
    closure_digits: Dict[Tuple[int, int], int] = {}
    free_digits = list(range(1, 100))

    def key(i):
        return ranks[i]

    out_frags = []
    for root in sorted(range(n), key=key):
        if visited[root]:
            continue
        # discover tree + closure bonds for this component
        tree: Dict[int, List[Tuple[int, int]]] = {i: [] for i in range(n)}
        closures: Dict[int, List[Tuple[int, int]]] = {i: [] for i in range(n)}
        comp_closure_bonds = []
        parent = {root: -1}
        # iterative DFS consistent with emission below
        def neighbors(i):
            return sorted(adj[i], key=lambda t: ranks[t[0]])
        dfs = [root]
        visited[root] = True
        state = {root: iter(neighbors(root))}
        while dfs:
            cur = dfs[-1]
            advanced = False
            for (nb, o) in state[cur]:
                if not visited[nb]:
                    visited[nb] = True
                    tree[cur].append((nb, o))
                    parent[nb] = cur
                    dfs.append(nb)
                    state[nb] = iter(neighbors(nb))
                    advanced = True
                    break
                elif nb != parent.get(cur, -1):
                    b = (min(cur, nb), max(cur, nb))
                    if b not in closure_digits and b not in [
                            x[0] for x in comp_closure_bonds]:
                        comp_closure_bonds.append((b, o))
            if not advanced:
                dfs.pop()
        for (a, b), o in comp_closure_bonds:
            d = free_digits.pop(0)
            closures[a].append((b, d))
            closures[b].append((a, d))
            closure_digits[(a, b)] = d

        def emit(i) -> str:
            s = atom_token(i)
            for (j, d) in sorted(closures[i], key=lambda t: t[1]):
                o = bonds[(min(i, j), max(i, j))]
                # the bond symbol goes on whichever endpoint is emitted
                # first (the parser stores it at ring-open, uses at close)
                tok = bond_token(i, j, o) if _closure_first(i, j) else ''
                s += tok + (f'%{d}' if d > 9 else str(d))
            kids = tree[i]
            for k, (j, o) in enumerate(kids):
                inner = bond_token(i, j, o) + emit(j)
                if k < len(kids) - 1:
                    s += '(' + inner + ')'
                else:
                    s += inner
            return s

        emitted_closure = set()

        def _closure_first(i, j):
            b = (min(i, j), max(i, j))
            if b in emitted_closure:
                return False
            emitted_closure.add(b)
            return True

        out_frags.append(emit(root))
        # release digits for reuse across fragments
        for (b, _o) in comp_closure_bonds:
            free_digits.append(closure_digits[b])
        free_digits.sort()

    return '.'.join(out_frags)
