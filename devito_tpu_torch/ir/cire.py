"""Cross-iteration redundancy elimination (reference:
devito/passes/clusters/aliases.py cire:34, the reference's flagship
flop-reduction pass; devito_tpu's ir/cire.py, whose rules this module
keeps so that both packages build the same schedule).

The reference extracts aliasing derivative subexpressions into Array
temporaries so its generated loops compute them once per block. Here each
temporary is a grid Function written by its own equation, which the
stencil kernel (kernels/stencil.py, the point design) runs like any other
update: nested rotated derivatives (TTI's ``Gzz = D_z'^T(b D_z' u)``) and
cross-equation shared operators (both TTI updates read ``Gxx`` and
``Gz``) are then computed once a step instead of once per tap of the
outer stencil and once per consumer.

This pass rewrites the *unevaluated* equations:

1. nested derivatives: every maximal derivative-containing subexpression
   sitting under another ``Derivative`` is materialized into a temporary
   grid Function, computed over a halo-extended region so the outer
   stencil's taps stay valid;
2. cross-equation sharing: top-level derivative subexpressions occurring
   in more than one equation are materialized once.

Rewrites are algebraically exact -- the temporary's expansion is identical
to what in-place evaluation would have produced at every consumed index --
so adjoint/gradient tolerances are unchanged.
"""

import sympy

from ..finite_differences.derivative import Derivative, _expr_any_stagger
from ..types.equation import Eq

__all__ = ['extract_derivative_temps']


def _has_deriv(expr):
    if isinstance(expr, Derivative):
        return True
    if not isinstance(expr, sympy.Basic):
        return False
    return any(_has_deriv(a) for a in expr.args)


def _deriv_radius(deriv):
    """Maximal stencil radius (grid points) of a Derivative's taps."""
    from ..finite_differences.tools import stencil_points
    from ..utils import as_tuple
    r = 0
    fd_orders = as_tuple(deriv._fd_order, len(deriv._dims))
    for (dim, order), fo in zip(deriv._dims, fd_orders):
        try:
            x0 = deriv._x0.get(dim, 0)
            x0 = sympy.Rational(sympy.sympify(x0) - dim) if \
                getattr(x0, 'free_symbols', None) else sympy.Rational(x0)
        except Exception:
            x0 = 0
        try:
            pairs = stencil_points(fo if fo else 2, order, x0=x0,
                                   transpose=deriv._transpose)
            r = max(r, max(abs(int(k)) for k, _ in pairs))
        except Exception:
            r = max(r, (int(fo or 2) + 1) // 2 + 1)
    return r


class _Extractor:
    def __init__(self, grid, dtype, space_order):
        self.grid = grid
        self.dtype = dtype
        self.space_order = space_order
        self.temps = []          # [(Function, expr, radius)]
        self.memo = {}           # srepr -> Function access

    def materialize(self, expr, radius, staggered=None):
        key = expr
        if key in self.memo:
            fn, old_r = self.memo[key]
            if radius > old_r:
                self.memo[key] = (fn, radius)
                for i, (f, e, r) in enumerate(self.temps):
                    if f is fn:
                        self.temps[i] = (f, e, radius)
            return fn
        from ..types.dense import Function
        fn = Function(name=f'cire{len(self.temps)}', grid=self.grid,
                      space_order=self.space_order, dtype=self.dtype,
                      staggered=staggered)
        type(fn)._compiler_temp = True
        self.memo[key] = (fn, radius)
        self.temps.append((fn, expr, radius))
        return fn

    def _rewrite_operand(self, expr, radius):
        """Replace every maximal derivative-containing subtree of a
        Derivative operand with a temp access."""
        if isinstance(expr, Derivative):
            # a nested Derivative: rewrite ITS operand first (bottom-up),
            # then materialize the whole node
            inner = self._rewrite_operand(expr.expr, _deriv_radius(expr))
            if inner is not expr.expr:
                expr = expr.func(inner)
            return self.materialize(expr, radius)
        if not isinstance(expr, sympy.Basic) or not expr.args:
            return expr
        if not _has_deriv(expr):
            return expr
        if isinstance(expr, sympy.Add):
            if all(_has_deriv(a) for a in expr.args):
                # pure derivative sum (e.g. the rotated Gz): one temp;
                # bottom-up — handle nesting inside each term first
                args = []
                for a in expr.args:
                    if isinstance(a, Derivative) and _has_deriv(a.expr):
                        inner = self._rewrite_operand(a.expr,
                                                      _deriv_radius(a))
                        a = a.func(inner)
                    args.append(a)
                return self.materialize(expr.func(*args), radius)
            # mixed: descend
        new_args = [self._rewrite_operand(a, radius) for a in expr.args]
        if all(n is o for n, o in zip(new_args, expr.args)):
            return expr
        try:
            return expr.func(*new_args)
        except TypeError:
            return expr.func(*new_args, evaluate=False)

    def rewrite_nested(self, expr):
        """Top-down walk: for each Derivative with derivative-containing
        operand, extract the operand's derivative subtrees."""
        if isinstance(expr, Derivative):
            if _has_deriv(expr.expr) and expr._method == 'FD' and \
                    expr._weights is None and \
                    not _expr_any_stagger(expr.expr):
                # staggered operands are left in place: a node-anchored
                # temporary would change the staggered-lattice projection
                # rules (elastic/viscoelastic systems)
                new_inner = self._rewrite_operand(expr.expr,
                                                  _deriv_radius(expr))
                if new_inner is not expr.expr:
                    return expr.func(new_inner)
            return expr
        if not isinstance(expr, sympy.Basic) or not expr.args:
            return expr
        new_args = [self.rewrite_nested(a) for a in expr.args]
        if all(n is o for n, o in zip(new_args, expr.args)):
            return expr
        try:
            return expr.func(*new_args)
        except TypeError:
            return expr.func(*new_args, evaluate=False)


def _top_level_deriv_groups(expr, out, terms=None):
    """Collect maximal derivative-containing subtrees of an rhs (for
    cross-equation sharing). When ``terms`` is given, also record each
    all-deriv Add's argument set — sympy flattens ``A + Gz`` so the Gz
    subtree that exists nested in one equation (under ``w*Gz``) is
    dissolved into siblings in another; matching single terms and
    re-coalescing them by owner set recovers the shared chunk (TTI: Hz's
    flattened Gz terms vs H0's nested ``sqrt(1+2delta)*Gz``)."""
    if isinstance(expr, Derivative):
        out.append(expr)
        return
    if not isinstance(expr, sympy.Basic) or not expr.args:
        return
    if isinstance(expr, sympy.Add) and _has_deriv(expr):
        pure = all(_has_deriv(a) for a in expr.args)
        if pure:
            out.append(expr)
        if terms is not None:
            # record the Add and its deriv-carrying args even when MIXED
            # (deriv terms sitting next to pointwise ones): that is
            # exactly the flattened form a coefficient-1 chunk takes
            # after sympy merges `w*Gxx + Gz` into a wider Add
            terms.append(expr)
        if pure:
            # nested groups under the args stay discoverable (a term
            # like w*Gxx keeps Gxx as a subtree)
            for a in expr.args:
                if not isinstance(a, Derivative):
                    for aa in a.args:
                        _top_level_deriv_groups(aa, out, terms)
            return
        for a in expr.args:
            _top_level_deriv_groups(a, out, terms)
        return
    for a in expr.args:
        _top_level_deriv_groups(a, out, terms)


def _replace_exact(expr, mapping):
    """Replacement of whole subtrees (sympy-equality keyed)."""
    if expr in mapping:
        return mapping[expr]
    if not isinstance(expr, sympy.Basic) or not expr.args:
        return expr
    new_args = [_replace_exact(a, mapping) for a in expr.args]
    if all(n is o for n, o in zip(new_args, expr.args)):
        return expr
    try:
        return expr.func(*new_args)
    except TypeError:
        return expr.func(*new_args, evaluate=False)


def extract_derivative_temps(expressions):
    """Run the pass over user Eq objects. Returns (temp_eqs, rewritten)
    where temp_eqs are new Eq objects (with ``_halo_write`` set to the
    required write-region extension) to be scheduled before the rewritten
    originals. Returns ([], expressions) when nothing qualifies."""
    eqs = [e for e in expressions if isinstance(e, Eq)]
    if not eqs:
        return [], expressions

    # pick grid/dtype/space_order from the first grid-backed lhs
    grid = dtype = so = None
    for e in eqs:
        fn = getattr(e.lhs, 'function', None)
        if fn is not None and getattr(fn, 'grid', None) is not None \
                and not fn.is_SparseFunction:
            grid, dtype = fn.grid, fn.dtype
            so = fn.space_order or 2
            break
    if grid is None:
        return [], expressions

    ex = _Extractor(grid, dtype, so)

    # pass 1: nested derivatives, recording which temps each eq spawned
    stage1 = []
    spawned = {}   # id(rewritten eq) -> [temp indices created for it]
    changed = False
    for e in expressions:
        n0 = len(ex.temps)
        if isinstance(e, Eq) and _has_deriv(e.rhs):
            new_rhs = ex.rewrite_nested(e.rhs)
            if new_rhs is not e.rhs:
                changed = True
                e = e.func(e.lhs, new_rhs, evaluate=False)
        spawned[id(e)] = list(range(n0, len(ex.temps)))
        stage1.append(e)

    # pass 2: cross-equation shared derivative groups (counted on the
    # stage-1 forms; rewritten with temps placed at their first consumer)
    owners = {}
    lhs_sigs = {}
    term_owners = {}
    term_sigs = {}
    addsets = {}     # id(eq) -> [frozenset(args) of its all-deriv Adds]
    for e in stage1:
        if isinstance(e, Eq) and _has_deriv(e.rhs):
            groups, adds = [], []
            _top_level_deriv_groups(e.rhs, groups, adds)
            lhs_fn = getattr(e.lhs, 'function', None)
            sig = getattr(lhs_fn, 'staggered', None) if lhs_fn is not None \
                else None
            for g in groups:
                owners.setdefault(g, set()).add(id(e))
                lhs_sigs.setdefault(g, set()).add(sig)
            addsets[id(e)] = [frozenset(a.args) for a in adds]
            for a in adds:
                for t in a.args:
                    if not _has_deriv(t):
                        continue
                    term_owners.setdefault(t, set()).add(id(e))
                    term_sigs.setdefault(t, set()).add(sig)
    # groups are extracted only when every consumer's lhs sits on ONE
    # common lattice (e.g. elastic's diag(div(v)) shared by the three
    # node diagonal stress equations): derivative evaluation anchors at
    # the consumer's stagger point, so even a plain-field derivative
    # consumed by an x-staggered and a y-staggered lhs expands
    # differently in each — one temp cannot serve both (caught by
    # test_tti_staggered_adjoint 3-D). The temp carries the common
    # lattice, so the _eval_at projection is unchanged.
    shared = {}
    for g, own in owners.items():
        if len(own) < 2 or len(lhs_sigs[g]) != 1:
            continue
        shared[g] = next(iter(lhs_sigs[g]))

    # pass 2b: term-coalesced sharing. sympy flattens `w*Gxx + Gz` so Gz
    # exists as a nested Add in one equation but as dissolved sibling
    # terms in the other — whole-node matching misses it (TTI centered:
    # both updates recomputed the full rotated Gz tap sum, ~100 ops + 19
    # transcendentals per point, while Gxx happened to stay nested and
    # was shared). Match individual deriv terms across equations,
    # coalesce the ones with identical owner sets back into one Add, and
    # share that — provided every owner has an Add containing the whole
    # class as siblings (else replacement could not land and the temp
    # would be waste).
    covered = set()
    for g in shared:
        covered.add(g)
        if isinstance(g, sympy.Add):
            covered.update(g.args)

    def _term_radius(t):
        r = 0
        for node in sympy.preorder_traversal(t):
            if isinstance(node, Derivative):
                r = max(r, _deriv_radius(node))
        return r

    classes = {}
    for t, own in term_owners.items():
        if len(own) < 2 or t in covered:
            continue
        if _term_radius(t) < 1:
            # pure half-point interpolations: a full-grid temp costs
            # more traffic than the 2-point recompute it saves
            continue
        if len(term_sigs[t]) != 1:
            # consumers on different lattices: the SAME term anchors at
            # each consumer's stagger point (a node-field derivative
            # consumed by an x-staggered lhs evaluates at x+h/2, by a
            # y-staggered lhs at y+h/2) — one temp cannot serve both
            # (caught by test_tti_staggered_adjoint 3-D: vx/vy sharing
            # broke the dot-product by 37%)
            continue
        classes.setdefault(frozenset(own), []).append(t)
    shared_subsets = []   # [(Add-of-terms, stagger)]
    for own, ts in classes.items():
        tset = frozenset(ts)
        if not all(any(tset <= s for s in addsets.get(eid, ()))
                   for eid in own):
            continue
        node = sympy.Add(*ts) if len(ts) > 1 else ts[0]
        if node in shared or node in covered:
            continue
        sigs = set().union(*[term_sigs[t] for t in ts])
        if len(sigs) != 1:
            continue
        # the temp anchors on the consumers' common lattice (same rule
        # as whole-group sharing above)
        stag = next(iter(sigs))
        shared_subsets.append((node, tset, stag))
    # largest classes first, so a big coalesced chunk wins over any
    # overlapping smaller one
    shared_subsets.sort(key=lambda x: -len(x[1]))

    stage2 = []
    for e in stage1:
        n0 = len(ex.temps)
        if (shared or shared_subsets) and isinstance(e, Eq) \
                and _has_deriv(e.rhs):
            mapping = {g: None for g in shared}
            stags = dict(shared)
            for node, tset, stag in shared_subsets:
                mapping.setdefault(node, None)
                stags.setdefault(node, stag)
            # materialize lazily so placement lands at the first consumer
            def _lookup(expr):
                if mapping[expr] is None:
                    mapping[expr] = ex.materialize(
                        expr, 0, staggered=stags[expr])
                return mapping[expr]

            def _map(expr):
                if expr in mapping:
                    return _lookup(expr)
                if not isinstance(expr, sympy.Basic) or not expr.args:
                    return expr
                if isinstance(expr, sympy.Add) and shared_subsets:
                    # replace coalesced sibling subsets (pass 2b): the
                    # class exists as args of this Add even though no
                    # single EQUAL subtree may exist — set membership,
                    # not node equality, because separately-built Adds
                    # of the same terms can canonical-sort differently
                    args = set(expr.args)
                    repl = []
                    for node, tset, _ in shared_subsets:
                        if tset <= args:
                            repl.append((node, tset))
                            args -= tset
                    if repl:
                        rest = [_map(a) for a in args]
                        return expr.func(*([_lookup(n) for n, _ in repl]
                                           + rest))
                new_args = [_map(a) for a in expr.args]
                if all(n is o for n, o in zip(new_args, expr.args)):
                    return expr
                try:
                    return expr.func(*new_args)
                except TypeError:
                    return expr.func(*new_args, evaluate=False)
            new_rhs = _map(e.rhs)
            if new_rhs is not e.rhs:
                changed = True
                e2 = e.func(e.lhs, new_rhs, evaluate=False)
                spawned[id(e2)] = spawned.pop(id(e), []) + \
                    list(range(n0, len(ex.temps)))
                e = e2
            else:
                spawned[id(e)] = spawned.get(id(e), []) + \
                    list(range(n0, len(ex.temps)))
        stage2.append(e)

    if not changed:
        return [], expressions

    def _temp_eq(idx):
        fn, expr, radius = ex.temps[idx]
        te = Eq(fn, expr, evaluate=False)
        te._halo_write = min(radius, min(h[0] for h in fn.halo) if fn.halo
                             else radius)
        return te

    # interleave: each temp right before its first consuming equation, so
    # temps reading body-written values (e.g. the adjoint's r.backward)
    # see the current iteration's value
    out = []
    emitted = set()
    for e in stage2:
        for idx in spawned.get(id(e), ()):
            if idx not in emitted:
                emitted.add(idx)
                out.append(_temp_eq(idx))
        out.append(e)
    for idx in range(len(ex.temps)):
        if idx not in emitted:
            out.append(_temp_eq(idx))
    return [], out
