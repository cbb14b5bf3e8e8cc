"""Exact two-centre eigenvalues E(R) for H2+ — the in-repo high-precision
oracle (>= 10 significant digits).

The reference's only ruler is the 4-decimal Wind (1965) table embedded at
``poc/main.py:48-61`` (+-0.05 mHa rounding), which this framework's flagship
models already saturate. This module solves the SEPARATED problem exactly:
in prolate spheroidal coordinates xi = (r1+r2)/D, eta = (r1-r2)/D (D = 2R the
full internuclear distance; this repo's R is the HALF distance), the
electronic Schroedinger equation (-1/2 lap - 1/r1 - 1/r2) psi = E psi
separates for psi = Lambda(xi) S(eta) e^{i m phi} (m = 0 sigma, |m| = 1 pi,
|m| = 2 delta states) into

    angular:  [(1-eta^2) S']' + (A + c^2 eta^2 - m^2/(1-eta^2)) S        = 0
    radial:   [(xi^2-1) L']'  + (-A + 2 D xi - c^2 xi^2 - m^2/(xi^2-1)) L = 0

with c^2 = -E D^2 / 2 and separation constant A.

- The angular equation is solved by associated-Legendre expansion
  S = sum_l c_l P_l^m(eta), l >= m (parity of l - m decouples even/odd,
  selecting e.g. 1s sigma_g / 2p sigma_u for m = 0, 2p pi_u / 3d pi_g for
  m = 1): with eta P_l^m = a_l P_{l+1}^m + b_l P_{l-1}^m,
  a_l = (l-m+1)/(2l+1), b_l = (l+m)/(2l+1), the c^2 eta^2 coupling is a
  banded matrix whose LARGEST eigenvalue (the branch continuing from l = m
  resp. m+1 at c = 0) gives A(c^2).
- The radial equation uses the Jaffe expansion
  L = (xi^2-1)^{m/2} (xi+1)^sigma e^{-c xi} sum_n g_n t^n,
  t = (xi-1)/(xi+1),  sigma = D/c - m - 1, whose coefficients obey the
  three-term recurrence (derived symbolically in this repo by series
  substitution — the sigma choice above is exactly what cancels the
  residual lower-row coupling — and verified against the Wind table,
  literature values and independent Rayleigh-Ritz bounds to 1e-10)

      alpha_n g_{n+1} + beta_n g_n + gamma_n g_{n-1} = 0,
      alpha_n = (n+1)(n+m+1),
      beta_n  = -A + 2D - c^2 - 2cm - 2c(2n+1) + m^2 + m
                + (m+2n+1) sigma - 2n^2,
      gamma_n = (n+m - D/c)(n - D/c)

  (m = 0 reduces exactly to Jaffe's classical sigma recurrence). L is
  normalisable iff {g_n} is the MINIMAL solution, i.e. the backward
  continued fraction for r_0 = g_1/g_0 satisfies  beta_0 + alpha_0 r_0 = 0.

E is the root of that scalar condition; everything is plain float64 numpy
(no jax), converging to ~1e-11 Ha — three orders below the 0.1 mHa target.
"""

from __future__ import annotations

import functools

import numpy as np

# States as (m, parity, angular branch, radial root index):
#   m is |m|, the axial angular momentum (0 sigma, 1 pi, 2 delta);
#   parity +1/-1 selects even/odd l - m sectors (for m = 0 that is
#     gerade/ungerade; for m > 0 the TOTAL inversion parity of the state is
#     parity * (-1)^m — e.g. 2p pi_u has even l - m);
#   branch k is the angular eigenvalue continuing from l = m + 2k +
#     (parity<0) at c = 0 (k eta-node pairs beyond the sector minimum);
#   root j is the j-th zero of the Jaffe radial condition scanning E upward
#     (j radial nodes in xi).
# United-atom labels: 1ssg (ground), 2psu (first ungerade), 2ssg (second
# gerade, one xi node), 3dsg (gerade, two eta nodes), 3psu (ungerade, one
# xi node); 2ppu / 3dpg are the pi-sector minima (He+ 2p / 3d at D -> 0),
# 3ddg the delta-sector minimum.
STATE_INDEX = {
    "1ssg": (0, 1, 0, 0),
    "2psu": (0, -1, 0, 0),
    "2ssg": (0, 1, 0, 1),
    "3dsg": (0, 1, 1, 0),
    "3psu": (0, -1, 0, 1),
    "3ssg": (0, 1, 0, 2),
    "2ppu": (1, 1, 0, 0),
    "3dpg": (1, -1, 0, 0),
    "3ppu": (1, 1, 0, 1),
    "3ddg": (2, 1, 0, 0),
    # n = 4 shell, first entry (round-4 stretch): 4f sigma_u is the first
    # state of the SECOND ungerade angular branch (l = 3 at c = 0) — the
    # famous diabatic partner of 2psu that correlates He+(4f, -0.125)
    # with H(n=2, -0.125): united- and separated-atom limits coincide.
    "4fsu": (0, -1, 1, 0),
    # ... and 4f phi_u, the m = 3 sector MINIMUM (trainable without
    # deflation, like 2ppu/3ddg): united atom He+(4f), separated atom
    # H(n=4) (m = 3 needs l >= 3). Total parity u = gerade envelope *
    # (-1)^3.
    "4fpu": (3, 1, 0, 0),
    # 4p sigma_u (round 5): THIRD radial state of the first ungerade
    # angular branch (two xi nodes) — united atom He+(4p, -1/8),
    # separated atom H(n=3, -1/18) as the UPHILL n = 3 Stark component
    # (E ~ -1/18 - 1/D + 9/D^2). Its E(R) crosses 4fsu's mid-range (the
    # separable problem's extra integral of motion permits same-sector
    # crossings), which is exactly why 4fsu is unreachable by plain
    # k-deflation: below the crossing the third ungerade state is 4psu,
    # above it 4fsu. Trained first, 4psu completes the reference list
    # that makes 4fsu the deflated minimum at EVERY R (DESIGN.md S12).
    "4psu": (0, -1, 0, 2),
    # Round-5 widening of the n = 4 shell into the m > 0 sectors.
    # Separated-atom correlations follow from the node counts: with
    # n_xi = root and n_eta = 2*branch + (parity < 0), the parabolic
    # quantum numbers at D -> infinity are n1 = n_xi, n2 = floor(n_eta/2),
    # n = n1 + n2 + m + 1, linear-Stark slope (3/2) n (n1 - n2) / D^2
    # (validated for every state in tests/test_exact.py).
    #
    # 4f delta_u: the m = 2 UNGERADE sector minimum (odd l - m branch from
    # l = 3) — trainable without deflation like 2ppu/3ddg/4fpu. United
    # atom He+(4f, -1/8); separated atom H(3d, -1/18), no linear Stark
    # (n1 = n2 = 0).
    "4fdu": (2, -1, 0, 0),
    # 4d pi_g: second pi_g state (one xi node on the 3dpg ladder; k = 1
    # deflation). United atom He+(4d); separated atom H(n=3) uphill
    # (n1 - n2 = +1). The rival second ANGULAR branch state 5g pi_g sits
    # >18 mHa ABOVE it everywhere in R <= 6 (no in-span crossing —
    # pinned in tests), so plain k-counting is safe here.
    "4dpg": (1, -1, 0, 1),
    # 4d delta_g: second delta_g state (one xi node on the 3ddg ladder;
    # k = 1). United atom He+(4d); separated atom H(n=4) uphill
    # (n1 - n2 = +1). Rival 5g delta_g stays >4 mHa above through R = 6.
    "4ddg": (2, 1, 0, 1),
    # 4f pi_u: the SECOND ANGULAR branch of pi_u (one eta-node pair,
    # l = 3 at c = 0) — and, unlike the sigma_u shell, it is the THIRD
    # pi_u state at EVERY R in span: it sits BELOW the radial 4p pi_u by
    # +0.7 mHa (R = 0.2) to +51 mHa (R = 4), no crossing (pinned in
    # tests). So k = 2 deflation against 2ppu + 3ppu reaches 4fpiu
    # directly; the radial 4ppu is the FOURTH pi_u state and needs k = 3.
    # United atom He+(4f); separated atom H(n=3) DOWNHILL (n2 = 1).
    # (Key is "4fpiu" not "4f pu" — "4fpu" already names 4f phi_u, the
    # m = 3 sector minimum; phi and pi collide in single-letter form.)
    "4fpiu": (1, 1, 1, 0),
    # 4p pi_u: third RADIAL pi_u state (two xi nodes) — the fourth pi_u
    # state in-span (see 4fpiu above). United atom He+(4p); separated
    # atom H(n=4) uphill with the largest Stark slope in the shell
    # (n1 - n2 = +2, slope 12/D^2).
    "4ppu": (1, 1, 0, 2),
}
STATES = tuple(STATE_INDEX)

# Lower edge of the full eigenvalue scan per sector minimum (the united-atom
# He+ level -Z^2/2n^2 with margin; the m = 0 sectors keep their historical
# wider windows — 2psu famously dips BELOW its united-atom level, to
# -0.6675 at D = 2, so windows are per-state data, not derivable from n).
_SCAN_LO = {"2ppu": -0.7, "3dpg": -0.6, "3ppu": -0.7, "3ddg": -0.6,
            "4fpu": -0.3,
            # n = 4 m > 0 shell: windows must sit below every LOWER root
            # of the same (m, parity, branch) ladder at every D (root
            # counting scans upward) — so the radial-ladder states
            # inherit their root-0 sibling's window, not their own dip.
            "4fdu": -0.6, "4dpg": -0.6, "4ddg": -0.6,
            "4fpiu": -0.7, "4ppu": -0.7}


def angular_eigenvalue(c2: float, parity: int, n_basis: int = 60,
                       branch: int = 0, m: int = 0) -> float:
    """Separation constant A(c^2) for the state of given parity
    (+1: even l-m branch from l=m; -1: odd branch from l=m+1). ``branch``
    = k picks the eigenvalue continuing from l = m + 2k (+1 for odd
    parity) at c = 0 — the k-th largest of the banded matrix.

    Associated-Legendre expansion: with
        eta P_l^m = a_l P_{l+1}^m + b_l P_{l-1}^m,
        a_l = (l-m+1)/(2l+1),  b_l = (l+m)/(2l+1),
    the row of P_l^m reads
        [A - l(l+1)] c_l + c^2 ( a_{l-2} a_{l-1} c_{l-2}
                                 + (a_l b_{l+1} + b_l a_{l-1}) c_l
                                 + b_{l+2} b_{l+1} c_{l+2} ) = 0.
    A = -(largest eigenvalue) of the resulting banded matrix. m = 0
    reduces to the classical Legendre sigma matrix.
    """
    af = lambda l: (l - m + 1) / (2 * l + 1)
    bf = lambda l: (l + m) / (2 * l + 1)
    ls = np.arange(m if parity > 0 else m + 1, m + 2 * n_basis,
                   2, dtype=np.float64)
    diag = -ls * (ls + 1) + c2 * (af(ls) * bf(ls + 1) + bf(ls) * af(ls - 1))
    # The matrix is tridiagonal with sub_i = c2 a_l a_{l+1} (row l+2 <- c_l)
    # and super_i = c2 b_{l+2} b_{l+1} (row l <- c_{l+2}); sub*super =
    # c2^2 (a a b b) >= 0 for every l >= m, so a diagonal similarity
    # symmetrises it exactly (off_i = sqrt(sub_i super_i)) — same spectrum,
    # but LAPACK's symmetric-tridiagonal solver replaces the dense
    # nonsymmetric Schur factorisation (~100x at n_basis = 60; the oracle's
    # hot inner call, profiled in round 5).
    from scipy.linalg import eigvalsh_tridiagonal
    sub = c2 * af(ls[:-1]) * af(ls[:-1] + 1)
    sup = c2 * bf(ls[:-1] + 2) * bf(ls[:-1] + 1)
    ev = eigvalsh_tridiagonal(diag, np.sqrt(sub * sup))[::-1]
    return -float(ev[branch])


def _angular_eigenvalues_vec(c2s: np.ndarray, parity: int, n_basis: int = 60,
                             branch: int = 0, m: int = 0) -> np.ndarray:
    """Vectorised angular_eigenvalue over a batch of c^2 values. Each
    matrix symmetrises to a real tridiagonal (see angular_eigenvalue), so
    a Python loop of LAPACK symmetric-tridiagonal solves (~30 us each at
    n_basis = 60) beats one batched dense nonsymmetric eigvals by ~100x —
    the batch's former cost was 88% of every oracle call."""
    from scipy.linalg import eigvalsh_tridiagonal
    af = lambda l: (l - m + 1) / (2 * l + 1)
    bf = lambda l: (l + m) / (2 * l + 1)
    ls = np.arange(m if parity > 0 else m + 1, m + 2 * n_basis,
                   2, dtype=np.float64)
    c2s = np.asarray(c2s, np.float64)
    diag0 = -ls * (ls + 1)
    dcoef = af(ls) * bf(ls + 1) + bf(ls) * af(ls - 1)
    # sqrt(sub * super) with the c2-independent part hoisted out
    ocoef = np.sqrt(af(ls[:-1]) * af(ls[:-1] + 1)
                    * bf(ls[:-1] + 2) * bf(ls[:-1] + 1))
    out = np.empty(len(c2s))
    for i, c2 in enumerate(c2s):
        ev = eigvalsh_tridiagonal(diag0 + c2 * dcoef, np.abs(c2) * ocoef)
        out[i] = -ev[::-1][branch]
    return out


def _radial_condition_vec(es: np.ndarray, d: float, a_seps: np.ndarray,
                          m: int, n_terms: int) -> np.ndarray:
    """Vectorised homogeneous Jaffe condition over a batch of E values
    sharing one series length (the sign consistency requirement): the
    backward recurrence runs ONCE with numpy vector ops — n_terms Python
    iterations total instead of n_terms * len(es)."""
    es = np.asarray(es, np.float64)
    c = d * np.sqrt(-es / 2.0)
    doc = d / c
    sig = doc - m - 1.0
    base = (-a_seps + 2.0 * d - c * c - 2.0 * c * m + m * m + m
            + (m + 1.0) * sig)

    def beta(n):
        return base - 2.0 * c * (2.0 * n + 1.0) + 2.0 * n * sig \
            - 2.0 * n * n

    p = 1.0 - 2.0 * np.sqrt(c / n_terms)
    q = np.ones_like(p)
    for n in range(n_terms, 0, -1):
        p, q = (-((n + m - doc) * (n - doc)) * q,
                beta(n) * q + (n + 1.0) * (n + m + 1.0) * p)
        if n % 8 == 0:
            # per-step growth can reach ~n^2 (beta_n ~ -2n^2), so the
            # window between rescale checks must stay well clear of the
            # float64 overflow ceiling: 8 steps x 1e11 growth < 1e100
            s = np.abs(p) + np.abs(q)
            bad = (s > 1e100) | (s < 1e-100)
            if bad.any():
                p = np.where(bad, p / s, p)
                q = np.where(bad, q / s, q)
    return beta(0) * q + (m + 1.0) * p


def _radial_condition(e: float, d: float, a_sep: float, m: int = 0,
                      n_terms: int | None = None) -> float:
    """Jaffe minimal-solution condition f(E) = beta_0 + alpha_0 r_0; a root
    in E (with A = A(c^2(E)) already consistent) is an exact eigenvalue."""
    c = d * np.sqrt(-e / 2.0)
    doc = d / c
    sig = doc - m - 1.0
    if n_terms is None:
        # series tail ~ exp(-4 sqrt(c n)): n >> (37/4)^2 / c for 1e-16
        n_terms = int(max(400, 120 / c))

    def beta(n):
        return (-a_sep + 2.0 * d - c * c - 2.0 * c * m
                - 2.0 * c * (2.0 * n + 1.0) + m * m + m
                + (m + 2.0 * n + 1.0) * sig - 2.0 * n * n)

    # Backward recurrence for the minimal-solution ratio r_n = g_{n+1}/g_n:
    #   r_{n-1} = -gamma_n / (beta_n + alpha_n r_n),
    # carried HOMOGENEOUSLY as r_n = p/q (rescaled each step) so the
    # returned condition C = beta_0 q + alpha_0 p is pole-free in E:
    # the scalar form beta_0 + alpha_0 r_0 has continued-fraction poles
    # that can sit arbitrarily close to a genuine root (observed for the
    # 3ssg root at D=4: pole and root ~2 mHa apart, cancelling the sign
    # change on any coarse scan); multiplying through by the denominator
    # chain keeps C continuous, with sign changes ONLY at eigenvalues.
    p = 1.0 - 2.0 * np.sqrt(c / n_terms)  # asymptotic minimal ratio
    q = 1.0
    for n in range(n_terms, 0, -1):
        p, q = (-((n + m - doc) * (n - doc)) * q,
                beta(n) * q + (n + 1.0) * (n + m + 1.0) * p)
        s = abs(p) + abs(q)
        if s > 1e100 or s < 1e-100:
            p /= s
            q /= s
    return beta(0) * q + (m + 1.0) * p  # n = 0 row: beta_0 g_0 + alpha_0 g_1


def _eigencondition(e: float, d: float, parity: int,
                    branch: int = 0, m: int = 0,
                    n_terms: int | None = None) -> float:
    c2 = -e * d * d / 2.0
    return _radial_condition(e, d, angular_eigenvalue(c2, parity,
                                                      branch=branch, m=m),
                             m=m, n_terms=n_terms)


def _quantized_n_terms(d: float, e: float) -> int:
    """Series length for E, quantized to a 400 * 2^k ladder. The
    homogeneous condition's SIGN carries an overall factor that depends on
    the series length, so adjacent sign comparisons must use the SAME
    n_terms or int(120/c) steps masquerade as roots; quantizing makes the
    length constant over long E stretches (re-anchoring is then rare) while
    keeping the cost local — a fixed whole-window length made small-D scans
    ~40x slower (n_terms ~ 1/c explodes toward E -> 0)."""
    c = d * np.sqrt(-e / 2.0)
    nt = 400
    while nt * c < 120.0 and nt < 1 << 22:
        nt *= 2
    return nt


def _find_bracket(d: float, parity: int, lo: float, hi: float,
                  n_scan: int, branch: int = 0,
                  n_root: int = 0, m: int = 0) -> tuple[float, float] | None:
    """Bracket of the ``n_root``-th genuine sign change of the eigenvalue
    condition on [lo, hi] (scanning upward: j-th root = j radial nodes).

    The homogeneous condition (see _radial_condition) is pole-free, so at
    fixed n_terms EVERY sign change is a genuine eigenvalue — no magnitude
    or crossing-direction heuristics needed (the scalar CF form had poles
    that could mask roots; fixed for the 3ssg root at D=4, where pole and
    root sat ~2 mHa apart). The scan is VECTORISED per n_terms ladder
    group (batched angular eigvals + one vector backward recurrence per
    group) and processes groups low-E-first with early exit, so the
    expensive large-n_terms tail toward E -> 0 is only computed when the
    root actually lies there."""
    es = np.linspace(lo, hi, n_scan)
    nts = np.array([_quantized_n_terms(d, e) for e in es])
    a_seps = _angular_eigenvalues_vec(-es * d * d / 2.0, parity,
                                      branch=branch, m=m)
    seen = 0
    f_prev = None          # last point of the previous group, at ITS nt
    i0 = 0
    # nt is monotone non-decreasing along es (c decreases toward E -> 0),
    # so the groups are contiguous
    while i0 < n_scan:
        nt = int(nts[i0])
        i1 = i0
        while i1 < n_scan and nts[i1] == nt:
            i1 += 1
        f = _radial_condition_vec(es[i0:i1], d, a_seps[i0:i1], m, nt)
        if i0 > 0:
            # re-anchor the previous group's last point at THIS group's
            # series length so the boundary sign pair is length-consistent
            f_prev = _radial_condition(float(es[i0 - 1]), d,
                                       float(a_seps[i0 - 1]), m, nt)
        for j in range(i1 - i0):
            fj = f[j]
            if f_prev is not None and np.isfinite(fj) \
                    and np.isfinite(f_prev) and f_prev * fj < 0.0:
                k = i0 + j
                if seen == n_root:
                    return (float(es[k - 1]), float(es[k]))
                seen += 1
            f_prev = fj
        i0 = i1
    return None


@functools.lru_cache(maxsize=4096)
def _exact_cached(r_half: float, state: str, tol: float,
                  guess: float | None) -> float:
    d = 2.0 * float(r_half)
    m, parity, branch, n_root = STATE_INDEX[state]
    bracket = None
    if guess is not None:
        # guess-guided fast path (e.g. the Wind interpolant, good to
        # +-5e-5): +-2 mHa around it must bracket the root — and contain
        # ONLY it, so the window searches for its first sign change
        bracket = _find_bracket(d, parity, guess - 2e-3, guess + 2e-3, 9,
                                branch, m=m)
    if bracket is None:
        # full scan upward from below the sector's floor (-2.2 covers He+
        # n=1 for the m=0 gerade sector; excited-state roots are counted
        # from the same floor so the j-th sign change is the j-th radial
        # state of the branch; m > 0 sectors use their own united-atom
        # windows from _SCAN_LO)
        lo = _SCAN_LO.get(state, -2.2 if parity > 0 else -1.0)
        bracket = _find_bracket(d, parity, lo, -1e-3, 400, branch, n_root,
                                m)
    if bracket is None:  # pragma: no cover
        raise RuntimeError(f"no eigenvalue bracket found for D={d}, {state}")
    from scipy.optimize import brentq
    nt = _quantized_n_terms(d, bracket[1])
    return float(brentq(
        lambda x: _eigencondition(x, d, parity, branch, m, nt),
        bracket[0], bracket[1], xtol=tol, rtol=8.9e-16))


def exact_electronic_energy(r_half: float, state: str = "1ssg",
                            tol: float = 1e-12,
                            guess: float | None = None) -> float:
    """Exact electronic eigenvalue E_el(R) in Hartree (excludes the 1/(2R)
    nuclear repulsion; R is the HALF internuclear distance, matching the
    framework's convention and the Wind table reference poc/main.py:48-61).

    ``guess``: optional prior (e.g. the Wind interpolant) — narrows the
    bracket scan from 400 evaluations to ~9.
    """
    if state not in STATES:
        raise ValueError(f"state must be one of {STATES}")
    return _exact_cached(float(r_half), state, tol,
                         None if guess is None else float(guess))


def exact_total_energy(r_half: float, state: str = "1ssg") -> float:
    """E_el + 1/(2R): the quantity the reference plots (poc/main.py:862)."""
    return exact_electronic_energy(r_half, state) + 1.0 / (2.0 * r_half)


def exact_surface(r_values, state: str = "1ssg",
                  guesses=None) -> np.ndarray:
    """Vectorised exact E_el over an array of half-distances."""
    rs = np.asarray(r_values, np.float64)
    gs = [None] * len(rs) if guesses is None else [
        None if not np.isfinite(g) else float(g)
        for g in np.asarray(guesses, np.float64)]
    return np.array([exact_electronic_energy(r, state, guess=g)
                     for r, g in zip(rs, gs)])
