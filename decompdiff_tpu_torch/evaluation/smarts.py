"""First-party SMARTS engine: pattern parsing + subgraph matching on
MolRecords (port of decompdiff_tpu/evaluation/smarts.py).

The reference reaches SMARTS through RDKit compiled catalogs
(ref utils/evaluation/scoring_func.py:15-25 `is_pains` via
FilterCatalogParams.FilterCatalogs.PAINS_A) — the one scoring role that had
no in-image execution path. This module implements the Daylight SMARTS
subset those catalogs use, over MolRecord graphs:

  atoms:   ``*  A  a``, organic-subset symbols (``C`` aliphatic / ``c``
           aromatic, incl. ``Cl``/``Br``), bracket expressions with
           primitives ``#n  D  H  h  X  x  R  R0  r  v  +  -  a  A``,
           recursive SMARTS ``$(...)``, logic ``!`` > ``&`` (implicit) >
           ``,`` > ``;``
  bonds:   ``- = # : ~ @`` with the same logic operators; default bond =
           single-or-aromatic
  grammar: branches ``( )``, ring closures (digits and ``%nn``),
           multi-component patterns via ``.`` (matched injectively)

Matching is standard backtracking subgraph isomorphism seeded along a DFS
spanning tree of the query — PAINS-scale patterns (5-30 atoms) against
drug-size molecules need no VF2 machinery.

Atom properties are derived from the record exactly as the descriptor
stack does (implicit_h_counts valence model, ligan SSSR rings); bracket
``H`` counts honor ``record.props['explicit_h']`` when the record came
from the SMILES parser.

Two divergences from Daylight/RDKit, kept as in the JAX package:
  * A lone bracket ``[H]`` parses as an H-count-1 primitive on the query
    atom itself (``_parse_bracket_expr``), where RDKit reads an explicit
    hydrogen atom and its catalog pipeline folds it into a >= 1 H
    constraint on the neighbouring heavy atom: ``[OX2][H]`` misses
    ethanol and matches isopropanol. Write ``[#1]`` for RDKit's meaning.
  * ``_merge_query_hs`` never merges query atom 0, so a top-level pattern
    whose first atom is ``[#1]`` keeps it as a graph atom and matches no
    heavy-atom-only record.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from decompdiff_tpu_torch.evaluation.smiles import SYMBOL_TO_Z, ORGANIC_SUBSET

AROMATIC_ORGANIC = ('c', 'n', 'o', 's', 'p', 'b')


def _default_valence_table():
    from decompdiff_tpu_torch.evaluation.descriptors import DEFAULT_VALENCES
    return {z: v[0] for z, v in DEFAULT_VALENCES.items()}


_DEFAULT_VALENCE = _default_valence_table()


class SmartsError(ValueError):
    pass


# --------------------------------------------------------------------------
# molecule context: per-atom/per-bond properties the primitives test

class MolContext:
    """Precomputed match properties for one MolRecord."""

    def __init__(self, record):
        from decompdiff_tpu_torch.evaluation.descriptors import (
            _undirected, implicit_h_counts, _rings)
        self.record = record
        n = record.num_atoms
        self.n = n
        self.z = np.asarray(record.element, np.int64)
        self.aromatic = np.asarray(record.aromatic, bool)
        self.charge = (np.asarray(record.charges, np.int64)
                       if record.charges is not None
                       else np.zeros(n, np.int64))
        bonds = _undirected(record)
        self.bond_order: Dict[Tuple[int, int], int] = dict(bonds)
        self.adj: List[List[int]] = [[] for _ in range(n)]
        for (a, b) in bonds:
            self.adj[a].append(b)
            self.adj[b].append(a)
        self.degree = np.array([len(a) for a in self.adj], np.int64)
        h = implicit_h_counts(self.z, bonds, record.charges)
        for idx, cnt in (record.props or {}).get('explicit_h', {}).items():
            h[idx] = cnt
        self.h = h
        order_sum = np.zeros(n)
        for (a, b), o in bonds.items():
            v = 1.5 if o == 4 else float(o)
            order_sum[a] += v
            order_sum[b] += v
        valence = np.round(order_sum).astype(np.int64) + h
        # RDKit semantics: an aromatic atom whose 1.5-per-aromatic-bond sum
        # (+H) exceeds its default valence (+charge) is snapped DOWN to it —
        # the excess is an artifact of the fractional bond model, and the
        # kekulized structure realizes the default (pyrrole [nH] is v3, not
        # v4; furan o / thiophene s are v2; N-methylpyrrole n is v3).
        for i in range(n):
            if not self.aromatic[i]:
                continue
            dv = _DEFAULT_VALENCE.get(int(self.z[i]))
            if dv is None:
                continue
            cap = dv + max(int(self.charge[i]), 0)
            if valence[i] > cap:
                valence[i] = cap
        self.valence = valence
        rings = _rings(record)
        self.ring_count = np.zeros(n, np.int64)
        self.min_ring = np.zeros(n, np.int64)  # 0 = not in a ring
        self.ring_bonds = set()
        for ring in rings:
            for a in ring:
                self.ring_count[a] += 1
                if self.min_ring[a] == 0 or len(ring) < self.min_ring[a]:
                    self.min_ring[a] = len(ring)
            for k in range(len(ring)):
                a, b = ring[k], ring[(k + 1) % len(ring)]
                self.ring_bonds.add((min(a, b), max(a, b)))
        self.ring_degree = np.zeros(n, np.int64)
        for (a, b) in self.ring_bonds:
            self.ring_degree[a] += 1
            self.ring_degree[b] += 1

    def order(self, a: int, b: int) -> int:
        return self.bond_order[(min(a, b), max(a, b))]

    def in_ring_bond(self, a: int, b: int) -> bool:
        return (min(a, b), max(a, b)) in self.ring_bonds


# --------------------------------------------------------------------------
# query expression trees

class Expr:
    __slots__ = ('op', 'args')

    def __init__(self, op, args):
        self.op = op      # 'and' | 'or' | 'not' | 'prim'
        self.args = args  # exprs, or (kind, value) for prim

    def __repr__(self):
        return f'Expr({self.op},{self.args})'


def _eval_atom(expr: Expr, ctx: MolContext, i: int) -> bool:
    if expr.op == 'and':
        return all(_eval_atom(e, ctx, i) for e in expr.args)
    if expr.op == 'or':
        return any(_eval_atom(e, ctx, i) for e in expr.args)
    if expr.op == 'not':
        return not _eval_atom(expr.args[0], ctx, i)
    kind, val = expr.args
    if kind == 'any':
        return True
    if kind == 'elem':            # (z, aromatic None=either/True/False)
        zq, arom = val
        if ctx.z[i] != zq:
            return False
        return arom is None or bool(ctx.aromatic[i]) == arom
    if kind == 'arom':
        return bool(ctx.aromatic[i]) == val
    if kind == 'D':
        return ctx.degree[i] == val
    if kind == 'H':
        return ctx.h[i] == val
    if kind == 'Hmin':               # merged [#1] query atoms
        return ctx.h[i] >= val
    if kind == 'X':
        return ctx.degree[i] + ctx.h[i] == val
    if kind == 'x':
        return ctx.ring_degree[i] == val
    if kind == 'R':
        if val is None:
            return ctx.ring_count[i] > 0
        return ctx.ring_count[i] == val
    if kind == 'r':
        if val is None:
            return ctx.ring_count[i] > 0
        return ctx.min_ring[i] == val
    if kind == 'v':
        return ctx.valence[i] == val
    if kind == 'charge':
        return ctx.charge[i] == val
    if kind == 'recursive':
        return _match_anchor(val, ctx, i)
    raise AssertionError(kind)


def _eval_bond(expr: Optional[Expr], ctx: MolContext, a: int, b: int) -> bool:
    if expr is None:  # default: single or aromatic
        return ctx.order(a, b) in (1, 4)
    if expr.op == 'and':
        return all(_eval_bond(e, ctx, a, b) for e in expr.args)
    if expr.op == 'or':
        return any(_eval_bond(e, ctx, a, b) for e in expr.args)
    if expr.op == 'not':
        return not _eval_bond(expr.args[0], ctx, a, b)
    kind, val = expr.args
    if kind == 'order':
        return ctx.order(a, b) == val
    if kind == 'anybond':
        return True
    if kind == 'ringbond':
        return ctx.in_ring_bond(a, b)
    raise AssertionError(kind)


# --------------------------------------------------------------------------
# SMARTS parser

class Pattern:
    """Parsed SMARTS pattern: query atoms + query bonds (+ components)."""

    def __init__(self, smarts: str):
        self.smarts = smarts
        self.atoms: List[Expr] = []
        self.bonds: List[Tuple[int, int, Optional[Expr]]] = []
        self.components: List[int] = []  # component id per query atom
        _parse_into(self, smarts)
        _merge_query_hs(self)
        # adjacency over query atoms
        self.qadj: List[List[Tuple[int, Optional[Expr]]]] = [
            [] for _ in self.atoms]
        for a, b, e in self.bonds:
            self.qadj[a].append((b, e))
            self.qadj[b].append((a, e))

    # -- matching ---------------------------------------------------------
    def _plans(self):
        """One DFS visit order per connected component:
        [(qatom, anchor_qatom_or_-1, bond_expr), ...]."""
        plans = []
        seen = set()
        for root in range(len(self.atoms)):
            if root in seen:
                continue
            order = [(root, -1, None)]
            seen.add(root)
            stack = [root]
            while stack:
                cur = stack.pop()
                for (nb, e) in self.qadj[cur]:
                    if nb not in seen:
                        seen.add(nb)
                        order.append((nb, cur, e))
                        stack.append(nb)
            plans.append(order)
        return plans

    def match(self, record_or_ctx) -> bool:
        """True if the pattern has at least one embedding."""
        ctx = (record_or_ctx if isinstance(record_or_ctx, MolContext)
               else MolContext(record_or_ctx))
        mapping: Dict[int, int] = {}
        used = set()
        return self._match_components(self._plans(), 0, ctx, mapping, used,
                                      anchor0=None)

    def match_at(self, ctx: MolContext, atom: int) -> bool:
        """True if an embedding exists mapping query atom 0 -> `atom`
        (recursive-SMARTS anchor semantics)."""
        mapping: Dict[int, int] = {}
        used = set()
        return self._match_components(self._plans(), 0, ctx, mapping, used,
                                      anchor0=atom)

    def find(self, record_or_ctx) -> List[Tuple[int, ...]]:
        """All distinct embeddings as tuples (query atom order)."""
        ctx = (record_or_ctx if isinstance(record_or_ctx, MolContext)
               else MolContext(record_or_ctx))
        out: List[Tuple[int, ...]] = []
        mapping: Dict[int, int] = {}
        used = set()
        self._match_components(self._plans(), 0, ctx, mapping, used,
                               anchor0=None, collect=out)
        return out

    def _match_components(self, plans, pi, ctx, mapping, used, anchor0,
                          collect=None):
        if pi == len(plans):
            if collect is not None:
                collect.append(tuple(mapping[q]
                                     for q in range(len(self.atoms))))
                return False  # keep searching
            return True
        return self._extend(plans, pi, 0, ctx, mapping, used, anchor0,
                            collect)

    def _extend(self, plans, pi, k, ctx, mapping, used, anchor0, collect):
        plan = plans[pi]
        if k == len(plan):
            return self._match_components(plans, pi + 1, ctx, mapping, used,
                                          anchor0, collect)
        q, anchor, bexpr = plan[k]
        if anchor < 0:
            if q == 0 and anchor0 is not None:
                cands: Sequence[int] = (
                    [anchor0] if anchor0 not in used else [])
            else:
                cands = [m for m in range(ctx.n) if m not in used]
        else:
            cands = [m for m in ctx.adj[mapping[anchor]] if m not in used]
        for m in cands:
            if not _eval_atom(self.atoms[q], ctx, m):
                continue
            if anchor >= 0 and not _eval_bond(bexpr, ctx, mapping[anchor], m):
                continue
            # closure bonds: every query bond between q and mapped atoms
            ok = True
            for (nb, e) in self.qadj[q]:
                if nb in mapping and nb != anchor:
                    ma, mb = mapping[nb], m
                    if (mb not in ctx.adj[ma]
                            or not _eval_bond(e, ctx, ma, mb)):
                        ok = False
                        break
            if not ok:
                continue
            mapping[q] = m
            used.add(m)
            if self._extend(plans, pi, k + 1, ctx, mapping, used, anchor0,
                            collect):
                return True
            del mapping[q]
            used.discard(m)
        return False


def _match_anchor(pattern: 'Pattern', ctx: MolContext, atom: int) -> bool:
    return pattern.match_at(ctx, atom)


def _merge_query_hs(pat: 'Pattern') -> None:
    """RDKit mergeQueryHs parity: explicit-hydrogen query atoms ([#1])
    cannot map onto heavy-atom-only MolRecords, so a plain [#1] hanging off
    a heavy query atom by a default/single/~ bond is removed and folded
    into a minimum-H-count constraint on that atom (real PAINS corpora,
    e.g. wehi_pains.csv, write most N-H/C-H this way). Unmergeable H atoms
    (multivalent, H-H bonded, exotic bond expr, or query atom 0 — the
    recursive-SMARTS anchor) stay as graph atoms and simply never match."""

    def _is_plain_h(expr: Expr) -> bool:
        return (expr.op == 'prim' and expr.args[0] == 'elem'
                and expr.args[1][0] == 1)

    def _bond_mergeable(e: Optional[Expr]) -> bool:
        if e is None:
            return True
        return (e.op == 'prim'
                and e.args in (('order', 1), ('anybond', None)))

    h_atoms = {q for q, a in enumerate(pat.atoms) if _is_plain_h(a)}
    if not h_atoms:
        return
    nb: Dict[int, List[Tuple[int, Optional[Expr]]]] = {}
    for a, b, e in pat.bonds:
        nb.setdefault(a, []).append((b, e))
        nb.setdefault(b, []).append((a, e))
    removed = set()
    for q in h_atoms:
        if q == 0:
            continue
        links = nb.get(q, [])
        if len(links) != 1:
            continue
        j, e = links[0]
        if j in h_atoms or not _bond_mergeable(e):
            continue
        removed.add(q)
    if not removed:
        return
    hmin: Dict[int, int] = {}
    for q in removed:
        j = nb[q][0][0]
        hmin[j] = hmin.get(j, 0) + 1
    keep = [q for q in range(len(pat.atoms)) if q not in removed]
    remap = {old: new for new, old in enumerate(keep)}
    atoms = []
    for old in keep:
        a = pat.atoms[old]
        n = hmin.get(old, 0)
        if n:
            a = Expr('and', [a, Expr('prim', ('Hmin', n))])
        atoms.append(a)
    pat.atoms = atoms
    pat.components = [pat.components[old] for old in keep]
    pat.bonds = [(remap[a], remap[b], e) for a, b, e in pat.bonds
                 if a not in removed and b not in removed]


# -- tokenizer/parser ------------------------------------------------------

def _parse_into(pat: Pattern, s: str) -> None:
    i = 0
    prev = -1
    pending: Optional[Expr] = None
    pending_set = False
    stack: List[int] = []
    ring: Dict[int, Tuple[int, Optional[Expr], bool]] = {}
    comp = 0

    def add_atom(expr) -> int:
        idx = len(pat.atoms)
        pat.atoms.append(expr)
        pat.components.append(comp)
        return idx

    def connect(idx):
        nonlocal prev, pending, pending_set
        if prev >= 0:
            pat.bonds.append((prev, idx, pending if pending_set else None))
        prev = idx
        pending, pending_set = None, False

    while i < len(s):
        c = s[i]
        if c == '[':
            expr, i = _parse_bracket_expr(s, i + 1)
            connect(add_atom(expr))
        elif c == '*':
            i += 1
            connect(add_atom(Expr('prim', ('any', None))))
        elif c == 'A':
            i += 1
            connect(add_atom(Expr('prim', ('arom', False))))
        elif c == 'a':
            i += 1
            connect(add_atom(Expr('prim', ('arom', True))))
        elif c.isupper():
            sym = None
            for cand in ORGANIC_SUBSET:
                if s.startswith(cand, i):
                    sym = cand
                    break
            if sym is None:
                raise SmartsError(f'unknown atom at {i} in {s!r}')
            i += len(sym)
            connect(add_atom(
                Expr('prim', ('elem', (SYMBOL_TO_Z[sym], False)))))
        elif c in AROMATIC_ORGANIC:
            i += 1
            connect(add_atom(
                Expr('prim', ('elem', (SYMBOL_TO_Z[c.upper()], True)))))
        elif c in '-=#:~@/\\':
            e, i = _parse_bond_expr(s, i)
            pending, pending_set = e, True
        elif c == '!':  # negated bond outside brackets, e.g. !@ or !-
            e, i = _parse_bond_expr(s, i)
            pending, pending_set = e, True
        elif c == '(':
            if prev < 0:
                raise SmartsError(f'component groups () at the top level '
                                  f'are not supported: {s!r}')
            stack.append(prev)
            i += 1
        elif c == ')':
            if not stack:
                raise SmartsError(f'unbalanced ) in {s!r}')
            prev = stack.pop()
            i += 1
        elif c == '.':
            prev, pending, pending_set = -1, None, False
            comp += 1
            i += 1
        elif c.isdigit() or c == '%':
            if c == '%':
                d = s[i + 1:i + 3]
                if len(d) < 2 or not d.isdigit():
                    raise SmartsError(f'% needs two digits at {i} in {s!r}')
                num, i = int(d), i + 3
            else:
                num, i = int(c), i + 1
            if prev < 0:
                raise SmartsError(f'ring closure before atom in {s!r}')
            if num in ring:
                other, e0, set0 = ring.pop(num)
                if (pending_set and set0
                        and repr(pending) != repr(e0)):
                    raise SmartsError(
                        f'conflicting ring-closure bond expressions '
                        f'for {num} in {s!r}')
                if pending_set:
                    e = pending
                elif set0:
                    e = e0
                else:
                    e = None
                pat.bonds.append((other, prev, e))
            else:
                ring[num] = (prev, pending, pending_set)
            pending, pending_set = None, False
        else:
            raise SmartsError(f'unexpected {c!r} at {i} in {s!r}')

    if stack:
        raise SmartsError(f'unbalanced ( in {s!r}')
    if ring:
        raise SmartsError(f'unclosed ring closure in {s!r}')
    if not pat.atoms:
        raise SmartsError('empty SMARTS')


def _parse_bond_expr(s: str, i: int) -> Tuple[Expr, int]:
    """Bond expression with ! & , ; logic (stops at anything non-bond)."""
    def prim(j):
        c = s[j]
        if c == '!':
            e, j2 = prim(j + 1)
            return Expr('not', [e]), j2
        if c in '-/\\':
            return Expr('prim', ('order', 1)), j + 1
        if c == '=':
            return Expr('prim', ('order', 2)), j + 1
        if c == '#':
            return Expr('prim', ('order', 3)), j + 1
        if c == ':':
            return Expr('prim', ('order', 4)), j + 1
        if c == '~':
            return Expr('prim', ('anybond', None)), j + 1
        if c == '@':
            return Expr('prim', ('ringbond', None)), j + 1
        raise SmartsError(f'bad bond primitive {c!r} at {j} in {s!r}')

    def parse_and_high(j):
        e, j = prim(j)
        terms = [e]
        while j < len(s):
            if s[j] == '&':
                e, j = prim(j + 1)
                terms.append(e)
            elif s[j] in '!-=#:~@/\\':
                e, j = prim(j)
                terms.append(e)
            else:
                break
        return (terms[0] if len(terms) == 1 else Expr('and', terms)), j

    def parse_or(j):
        e, j = parse_and_high(j)
        terms = [e]
        while j < len(s) and s[j] == ',':
            e, j = parse_and_high(j + 1)
            terms.append(e)
        return (terms[0] if len(terms) == 1 else Expr('or', terms)), j

    def parse_and_low(j):
        e, j = parse_or(j)
        terms = [e]
        while j < len(s) and s[j] == ';':
            e, j = parse_or(j + 1)
            terms.append(e)
        return (terms[0] if len(terms) == 1 else Expr('and', terms)), j

    return parse_and_low(i)


def _read_int(s: str, i: int) -> Tuple[Optional[int], int]:
    d = ''
    while i < len(s) and s[i].isdigit():
        d += s[i]
        i += 1
    return (int(d) if d else None), i


def _parse_bracket_expr(s: str, i: int) -> Tuple[Expr, int]:
    """Parse a bracket atom expression starting after '['; returns
    (expr, index after ']')."""

    def prim(j):
        c = s[j]
        if c == '!':
            e, j2 = prim(j + 1)
            return Expr('not', [e]), j2
        if c == '$':
            if s[j + 1] != '(':
                raise SmartsError(f'$ without ( in {s!r}')
            depth, k = 1, j + 2
            while k < len(s) and depth:
                if s[k] == '(':
                    depth += 1
                elif s[k] == ')':
                    depth -= 1
                k += 1
            if depth:
                raise SmartsError(f'unbalanced $() in {s!r}')
            return (Expr('prim', ('recursive', Pattern(s[j + 2:k - 1]))), k)
        if c == '*':
            return Expr('prim', ('any', None)), j + 1
        if c == '#':
            n, j2 = _read_int(s, j + 1)
            if n is None:
                raise SmartsError(f'# without number in {s!r}')
            return Expr('prim', ('elem', (n, None))), j2
        if c == 'a':
            return Expr('prim', ('arom', True)), j + 1
        if c == 'A':
            return Expr('prim', ('arom', False)), j + 1
        if c in 'DHhXxRrv':
            n, j2 = _read_int(s, j + 1)
            if c == 'D':
                return Expr('prim', ('D', 1 if n is None else n)), j2
            if c in 'Hh':
                return Expr('prim', ('H', 1 if n is None else n)), j2
            if c == 'X':
                return Expr('prim', ('X', 1 if n is None else n)), j2
            if c == 'x':
                if n is None:
                    return Expr('prim', ('R', None)), j2
                return Expr('prim', ('x', n)), j2
            if c == 'R':
                if n == 0:
                    return Expr('not', [Expr('prim', ('R', None))]), j2
                return Expr('prim', ('R', n)), j2
            if c == 'r':
                return Expr('prim', ('r', n)), j2
            if c == 'v':
                return Expr('prim', ('v', 1 if n is None else n)), j2
        if c in '+-':
            sign = 1 if c == '+' else -1
            run = 0
            j2 = j
            while j2 < len(s) and s[j2] == c:
                run += 1
                j2 += 1
            n, j2 = _read_int(s, j2)
            q = sign * (n if n is not None else run)
            return Expr('prim', ('charge', q)), j2
        # element symbol (two-letter first), aromatic lowercase, or 'N' etc.
        if c.isalpha():
            if c.isupper():
                sym = c
                if (j + 1 < len(s) and s[j + 1].islower()
                        and sym + s[j + 1] in SYMBOL_TO_Z
                        # lone 'c'/'n'/... after an element is its own
                        # aromatic primitive only if the two-letter symbol
                        # is not a real element (Sc vs S,c is ambiguous;
                        # Daylight reads two-letter symbols greedily)
                        ):
                    sym2 = sym + s[j + 1]
                    # uppercase bracket symbols are aliphatic (Daylight);
                    # same rule as the single-letter branch below
                    return (Expr('prim',
                                 ('elem', (SYMBOL_TO_Z[sym2], False))),
                            j + 2)
                if sym not in SYMBOL_TO_Z:
                    raise SmartsError(f'unknown symbol {sym!r} in {s!r}')
                return (Expr('prim', ('elem', (SYMBOL_TO_Z[sym], False))),
                        j + 1)
            else:
                up = c.upper()
                if up not in SYMBOL_TO_Z:
                    raise SmartsError(f'unknown symbol {c!r} in {s!r}')
                return (Expr('prim', ('elem', (SYMBOL_TO_Z[up], True))),
                        j + 1)
        if c == '@':
            # chirality in queries: accept and ignore (matches anything)
            j2 = j
            while j2 < len(s) and s[j2] == '@':
                j2 += 1
            return Expr('prim', ('any', None)), j2
        raise SmartsError(f'bad atom primitive {c!r} at {j} in {s!r}')

    def parse_and_high(j):
        e, j = prim(j)
        terms = [e]
        while j < len(s) and s[j] not in ',;]':
            if s[j] == '&':
                j += 1
                if s[j] in ',;]':
                    raise SmartsError(f'dangling & in {s!r}')
            e, j = prim(j)
            terms.append(e)
        return (terms[0] if len(terms) == 1 else Expr('and', terms)), j

    def parse_or(j):
        e, j = parse_and_high(j)
        terms = [e]
        while j < len(s) and s[j] == ',':
            e, j = parse_and_high(j + 1)
            terms.append(e)
        return (terms[0] if len(terms) == 1 else Expr('or', terms)), j

    def parse_and_low(j):
        e, j = parse_or(j)
        terms = [e]
        while j < len(s) and s[j] == ';':
            e, j = parse_or(j + 1)
            terms.append(e)
        return (terms[0] if len(terms) == 1 else Expr('and', terms)), j

    expr, j = parse_and_low(i)
    if j >= len(s) or s[j] != ']':
        raise SmartsError(f'expected ] at {j} in {s!r}')
    return expr, j + 1


@lru_cache(maxsize=4096)            # PAINS(480) + Brenk(105) must co-reside
def compile_smarts(smarts: str) -> Pattern:
    """Parse + cache a SMARTS pattern."""
    return Pattern(smarts)


def has_substruct(record, smarts: str) -> bool:
    """RDKit `mol.HasSubstructMatch(MolFromSmarts(smarts))` analog."""
    return compile_smarts(smarts).match(record)
