"""First-party SMILES parser and writer: SMILES string <-> MolRecord graph
(port of decompdiff_tpu/evaluation/smiles.py; the valence helpers come from
evaluation/descriptors.py, as there).

The reference round-trips molecules through RDKit SMILES in several places
(e.g. ref utils/evaluation/scoring_func.py via Chem.MolFromSmiles in
docking prep, utils/transforms.py fragment queries); this module gives the
RDKit-free stack the same capability for GRAPHS (no coordinates — `pos` is
zero-filled; use utils/confgen for 3D embedding). The result rows of the
sampling driver carry the writer's output (ref
scripts/sample_diffusion_decomp.py:432 Chem.MolToSmiles).

Supported SMILES (Daylight core, the subset drug-like molecules use):
  - organic subset atoms  B C N O P S F Cl Br I  and aromatic  b c n o s p
  - bracket atoms ``[isotope? symbol chirality? Hcount? charge? :map?]``
    (isotope/chirality/atom-map parsed and discarded for the graph)
  - bonds ``- = # : / \\`` (directional bonds collapse to single), default
    bond single (aromatic between two aromatic atoms)
  - branches ``( )``, ring closures ``1``-``9`` and ``%nn``, disconnected
    fragments via ``.``

Explicit bracket H-counts are recorded in ``record.props['explicit_h']``
(dict atom-index -> count) so descriptor/SMARTS code can honor them where
the implicit-valence model would differ (e.g. pyrrole ``[nH]``).

Divergence from RDKit, kept as in the JAX package: the default bond
between two aromatic atoms is stored as order 4 even when the atoms lie in
different rings (biphenyl written ``c1ccccc1c1ccccc1``), where RDKit's
sanitization demotes such a non-ring bond to single; write the ``-``
explicitly for RDKit's graph.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from decompdiff_tpu_torch.data.mol import MolRecord
from decompdiff_tpu_torch.evaluation.descriptors import (
    DEFAULT_VALENCES, _undirected, implicit_h_counts)

# two-letter symbols first so the tokenizer is greedy
ORGANIC_SUBSET = ('Cl', 'Br', 'B', 'C', 'N', 'O', 'P', 'S', 'F', 'I')
AROMATIC_ORGANIC = ('b', 'c', 'n', 'o', 's', 'p')

SYMBOL_TO_Z = {
    'H': 1, 'He': 2, 'Li': 3, 'Be': 4, 'B': 5, 'C': 6, 'N': 7, 'O': 8,
    'F': 9, 'Ne': 10, 'Na': 11, 'Mg': 12, 'Al': 13, 'Si': 14, 'P': 15,
    'S': 16, 'Cl': 17, 'K': 19, 'Ca': 20, 'Mn': 25, 'Fe': 26, 'Co': 27,
    'Ni': 28, 'Cu': 29, 'Zn': 30, 'As': 33, 'Se': 34, 'Br': 35, 'I': 53,
}

BOND_CHARS = {'-': 1, '=': 2, '#': 3, ':': 4, '/': 1, '\\': 1}


class SmilesError(ValueError):
    pass


def _parse_bracket(s: str, i: int):
    """Parse the body of a bracket atom starting after '['. Returns
    (z, aromatic, h_count, charge, next_index)."""
    j = s.find(']', i)
    if j < 0:
        raise SmilesError(f'unterminated bracket atom in {s!r}')
    body = s[i:j]
    k = 0
    # isotope
    while k < len(body) and body[k].isdigit():
        k += 1
    # symbol (may be aromatic lowercase or '*')
    if k >= len(body):
        raise SmilesError(f'empty bracket atom in {s!r}')
    if body[k] == '*':
        sym, k = '*', k + 1
    elif body[k].islower():
        sym, k = body[k], k + 1
    else:
        sym = body[k]
        k += 1
        if k < len(body) and body[k].islower() and sym + body[k] in SYMBOL_TO_Z:
            sym += body[k]
            k += 1
    aromatic = sym.islower()
    lookup = sym.capitalize() if aromatic else sym
    if sym == '*':
        z = 0
    else:
        z = SYMBOL_TO_Z.get(lookup)
        if z is None:
            raise SmilesError(f'unknown element {sym!r} in {s!r}')
    # chirality (discarded)
    while k < len(body) and body[k] == '@':
        k += 1
    if k < len(body) and body[k:k + 2] in ('TH', 'AL', 'SP', 'TB', 'OH'):
        k += 2
        while k < len(body) and body[k].isdigit():
            k += 1
    # explicit H count
    h_count: Optional[int] = None
    if k < len(body) and body[k] == 'H':
        k += 1
        d = ''
        while k < len(body) and body[k].isdigit():
            d += body[k]
            k += 1
        h_count = int(d) if d else 1
    # charge
    charge = 0
    if k < len(body) and body[k] in '+-':
        sign = 1 if body[k] == '+' else -1
        run = 0
        while k < len(body) and body[k] in '+-':
            run += 1
            k += 1
        d = ''
        while k < len(body) and body[k].isdigit():
            d += body[k]
            k += 1
        charge = sign * (int(d) if d else run)
    # atom map (discarded)
    if k < len(body) and body[k] == ':':
        k += 1
        while k < len(body) and body[k].isdigit():
            k += 1
    if k != len(body):
        raise SmilesError(f'trailing {body[k:]!r} in bracket atom of {s!r}')
    return z, aromatic, h_count, charge, j + 1


def mol_from_smiles(smiles: str, name: str = '') -> MolRecord:
    """Parse a SMILES string into a MolRecord (graph only, zero coords)."""
    s = smiles.strip()
    element: List[int] = []
    aromatic: List[bool] = []
    charges: List[int] = []
    explicit_h: Dict[int, int] = {}
    bonds: Dict[Tuple[int, int], int] = {}
    stack: List[int] = []
    ring: Dict[int, Tuple[int, Optional[int]]] = {}
    prev = -1
    pending: Optional[int] = None
    i = 0

    def add_atom(z, arom, h, q):
        idx = len(element)
        element.append(z)
        aromatic.append(arom)
        charges.append(q)
        if h is not None:
            explicit_h[idx] = h
        return idx

    def add_bond(a, b, order):
        if a == b or (min(a, b), max(a, b)) in bonds:
            raise SmilesError(f'duplicate/self bond {a}-{b} in {smiles!r}')
        bonds[(min(a, b), max(a, b))] = order

    def connect(idx):
        nonlocal prev, pending
        if prev >= 0:
            order = pending
            if order is None:
                order = 4 if (aromatic[prev] and aromatic[idx]) else 1
            add_bond(prev, idx, order)
        prev = idx
        pending = None

    while i < len(s):
        c = s[i]
        if c == '[':
            z, arom, h, q, i = _parse_bracket(s, i + 1)
            connect(add_atom(z, arom, h, q))
        elif c.isupper():
            sym = None
            for cand in ORGANIC_SUBSET:
                if s.startswith(cand, i):
                    sym = cand
                    break
            if sym is None:
                raise SmilesError(f'unknown organic-subset atom at {i} '
                                  f'in {smiles!r}')
            i += len(sym)
            connect(add_atom(SYMBOL_TO_Z[sym], False, None, 0))
        elif c in AROMATIC_ORGANIC:
            i += 1
            connect(add_atom(SYMBOL_TO_Z[c.upper()], True, None, 0))
        elif c in BOND_CHARS:
            pending = BOND_CHARS[c]
            i += 1
        elif c == '(':
            if prev < 0:
                raise SmilesError(f'branch before any atom in {smiles!r}')
            stack.append(prev)
            i += 1
        elif c == ')':
            if not stack:
                raise SmilesError(f'unbalanced ) in {smiles!r}')
            prev = stack.pop()
            i += 1
        elif c == '.':
            # disconnected fragment: next atom starts with no bond to prev
            prev, pending = -1, None
            i += 1
        elif c.isdigit() or c == '%':
            if c == '%':
                d = s[i + 1:i + 3]
                if len(d) < 2 or not d.isdigit():
                    raise SmilesError(f'% needs two digits at {i} '
                                      f'in {smiles!r}')
                num, i = int(d), i + 3
            else:
                num, i = int(c), i + 1
            if prev < 0:
                raise SmilesError(f'ring closure before atom in {smiles!r}')
            if num in ring:
                other, order0 = ring.pop(num)
                if (pending is not None and order0 is not None
                        and pending != order0):
                    raise SmilesError(
                        f'conflicting ring-closure bond orders '
                        f'{order0} vs {pending} for %{num} in {smiles!r}')
                order = pending if pending is not None else order0
                if order is None:
                    order = 4 if (aromatic[prev] and aromatic[other]) else 1
                add_bond(prev, other, order)
            else:
                ring[num] = (prev, pending)
            pending = None
        elif c in ' \t':
            break  # SMILES title field
        else:
            raise SmilesError(f'unexpected {c!r} at {i} in {smiles!r}')

    if stack:
        raise SmilesError(f'unbalanced ( in {smiles!r}')
    if ring:
        raise SmilesError(f'unclosed ring closures {sorted(ring)} '
                          f'in {smiles!r}')
    if not element:
        raise SmilesError('empty SMILES')

    n = len(element)
    if bonds:
        und = np.array(sorted(bonds), np.int64).T
        orders = np.array([bonds[tuple(b)] for b in und.T], np.int64)
        bond_index = np.concatenate([und, und[::-1]], axis=1)
        bond_type = np.concatenate([orders, orders])
    else:
        bond_index = np.zeros((2, 0), np.int64)
        bond_type = np.zeros((0,), np.int64)
    rec = MolRecord(
        element=np.array(element, np.int64),
        pos=np.zeros((n, 3), np.float32),
        bond_index=bond_index,
        bond_type=bond_type,
        aromatic=np.array(aromatic, bool),
        name=name or smiles,
        charges=np.array(charges, np.int64),
    )
    if explicit_h:
        rec.props['explicit_h'] = explicit_h
    return rec


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
