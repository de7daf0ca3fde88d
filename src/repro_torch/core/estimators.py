"""Closed-form aggregate estimators with error bars (paper Table 2 + §4.3;
counterpart of `repro.core.estimators`).

Estimates are Horvitz–Thompson corrected: every sampled row i carries an
exact inclusion probability rate_i = min(1, K/F_i) and HT weight
w_i = 1/rate_i. The HT variance has the closed form
Var = Σ (1-rate_i)/rate_i² · x_i², estimated from the sample itself.
Moments and estimates stay float32, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core.types import AggOp

# Cephes rational approximations of the inverse normal CDF, as the
# reference evaluates them (jax.scipy.special.ndtri) — in float32.
_NDTRI_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1,
             -5.66762857469070293439E1, 1.39312609387279679503E1,
             -1.23916583867381258016E0)
_NDTRI_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0,
             8.63602421390890590575E1, -2.25462687854119370527E2,
             2.00260212380060660359E2, -8.20372256168333339912E1,
             1.59056225126211695515E1, -1.18331621121330003142E0)
_NDTRI_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1,
             5.71628192246421288162E1, 4.40805073893200834700E1,
             1.46849561928858024014E1, 2.18663306850790267539E0,
             -1.40256079171354495875E-1, -3.50424626827848203418E-2,
             -8.57456785154685413611E-4)
_NDTRI_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1,
             4.13172038254672030440E1, 1.50425385692907503408E1,
             2.50464946208309415979E0, -1.42182922854787788574E-1,
             -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_NDTRI_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0,
             3.93881025292474443415E0, 1.33303460815807542389E0,
             2.01485389549179081538E-1, 1.23716634817820021358E-2,
             3.01581553508235416007E-4, 2.65806974686737550832E-6,
             6.23974539184983293730E-9)
_NDTRI_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0,
             1.37702099489081330271E0, 2.16236993594496635890E-1,
             1.34204006088543189037E-2, 3.28014464682127739104E-4,
             2.89247864745380683936E-6, 6.79019408009981274425E-9)


def _fma_f32(a, b, c) -> np.float32:
    """Fused multiply-add of float32 operands rounded once to float32. The
    float32 product is exact in float64; the float64 sum s is not, so its
    exact residual (TwoSum) decides the one case where rounding s to
    float32 would round twice: s on a float32 midpoint with a nonzero
    residual goes to the neighbour on the residual's side."""
    p = float(np.float64(a) * np.float64(b))
    cd = float(c)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = np.float32(s)
    if err != 0.0 and math.isfinite(s):
        below = r if float(r) <= s else np.nextafter(r, np.float32(-np.inf))
        above = np.nextafter(below, np.float32(np.inf))
        if np.isfinite(above) and (float(below) + float(above)) * 0.5 == s:
            r = above if err > 0.0 else below
    return r


def _polyval_f32(coeffs, x: np.float32) -> np.float32:
    """Horner's rule as the reference's compiled polyval runs it: each step
    one FMA."""
    y = np.float32(0.0)
    for c in coeffs:
        y = _fma_f32(y, x, np.float32(c))
    return y


# Cephes log coefficients, as the reference's CPU backend evaluates logf.
_LOG_P = tuple(np.float32(c) for c in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))


def _log_f32(v: np.float32) -> np.float32:
    """Natural log of a positive normal float32, rounded step by step as the
    reference's CPU backend computes it (numpy's logf differs in the last
    ulp for some inputs)."""
    f = np.float32
    m, e = np.frexp(f(v))
    m, e = f(m), f(e)
    if m < f(0.707106781186547524):
        e = f(e - f(1.0))
        x = f(f(m - f(1.0)) + m)
    else:
        x = f(m - f(1.0))
    x2 = f(x * x)
    x3 = f(x2 * x)
    p = _LOG_P
    y = _fma_f32(_fma_f32(p[0], x, p[1]), x, p[2])
    y1 = _fma_f32(_fma_f32(p[3], x, p[4]), x, p[5])
    y2 = _fma_f32(_fma_f32(p[6], x, p[7]), x, p[8])
    y = _fma_f32(y, x3, y1)
    y = _fma_f32(y, x3, y2)
    y = _fma_f32(y, x3, f(e * f(-2.12194440e-4)))
    x = f(x - f(x2 * f(0.5)))
    x = f(x + y)
    return _fma_f32(e, f(0.693359375), x)


def ndtri_f32(p: float) -> float:
    """Inverse normal CDF evaluated in float32 exactly as the reference's
    jax.scipy.special.ndtri evaluates it (torch.special.ndtri rounds
    differently: a chosen K or bound verdict at the margin can flip on one
    ulp of z)."""
    f = np.float32
    p = f(p)
    if p == f(0.0):
        return float("-inf")
    if p == f(1.0):
        return float("inf")
    mcp = f(1.0) - p if p > f(-np.expm1(-2.0)) else p
    if mcp > f(np.exp(-2.0)):
        w = f(mcp - f(0.5))
        ww = f(w * w)
        x = f(w + f(f(w * ww) * f(_polyval_f32(_NDTRI_P0, ww)
                                   / _polyval_f32(_NDTRI_Q0, ww))))
        x = f(x * -f(np.sqrt(2.0 * np.pi)))
    else:
        z = f(np.sqrt(f(f(-2.0) * f(_log_f32(mcp)))))
        first = f(z - f(_log_f32(z) / z))
        inv = f(f(1.0) / z)
        if z >= f(8.0):
            second = f(f(_polyval_f32(_NDTRI_P2, inv)
                         / _polyval_f32(_NDTRI_Q2, inv)) / z)
        else:
            second = f(f(_polyval_f32(_NDTRI_P1, inv)
                         / _polyval_f32(_NDTRI_Q1, inv)) / z)
        x = f(first - second)
    if not p > f(1.0 - np.exp(-2.0)):
        x = -x
    return float(x)


@functools.lru_cache(maxsize=None)
def z_value(confidence: float) -> float:
    """Two-sided normal quantile, e.g. 0.95 -> 1.96 (float32 arithmetic)."""
    return ndtri_f32(0.5 + confidence / 2.0)


@dataclasses.dataclass
class GroupedMoments:
    """Per-group sufficient statistics from one sample scan (f32 tensors;
    leaves are [G], or [Q, G] for a multi-query scan)."""
    n: torch.Tensor           # selected rows (unweighted)
    wsum: torch.Tensor        # Σ w_i                (HT count)
    wxsum: torch.Tensor       # Σ w_i x_i            (HT sum)
    wx2sum: torch.Tensor      # Σ w_i x_i²
    var_count: torch.Tensor   # Σ (1-r_i)/r_i²       (HT count variance)
    var_sum: torch.Tensor     # Σ (1-r_i)/r_i² x_i   (cross term)
    var_sum2: torch.Tensor    # Σ (1-r_i)/r_i² x_i²  (HT sum variance)

    @classmethod
    def from_stacked(cls, out: torch.Tensor) -> "GroupedMoments":
        """[..., 7, G] stacked statistics (kernel layout) -> moments."""
        return cls(*(out[..., i, :] for i in range(7)))

    def stacked(self) -> torch.Tensor:
        return torch.stack([self.n, self.wsum, self.wxsum, self.wx2sum,
                            self.var_count, self.var_sum, self.var_sum2],
                           dim=-2)


def grouped_moments(values: torch.Tensor, rates: torch.Tensor,
                    mask: torch.Tensor, group_codes: torch.Tensor,
                    n_groups: int,
                    accumulate: torch.dtype = torch.float32) -> GroupedMoments:
    """Segment-reduce the sufficient statistics with index_add_. Per-row
    terms are float32 as in the reference; `accumulate=torch.float64` sums
    them in double (the exact base-table scan, whose counts pass 2^24) and
    rounds the totals to float32. Rows whose code lies outside
    [0, n_groups) land in no group, as the reference's segment_sum drops
    them (a join's dangling foreign key gathers the code -1)."""
    g = group_codes.to(torch.int64)
    keep = (g >= 0) & (g < n_groups)
    if not bool(keep.all()):
        values, rates, mask, g = values[keep], rates[keep], mask[keep], g[keep]
    m = mask.to(torch.float32)
    w = m / rates
    x = values.to(torch.float32)
    vfac = m * (1.0 - rates) / (rates * rates)

    def seg(v):
        out = torch.zeros(n_groups, dtype=accumulate, device=v.device)
        return out.index_add_(0, g, v.to(accumulate)).to(torch.float32)

    return GroupedMoments(
        n=seg(m), wsum=seg(w), wxsum=seg(w * x), wx2sum=seg(w * x * x),
        var_count=seg(vfac), var_sum=seg(vfac * x), var_sum2=seg(vfac * x * x))


def reweight_moments(mom: GroupedMoments, factor: float) -> GroupedMoments:
    """Second-phase HT correction after losing fault-domain shards.

    Shards are disjoint stratum partitions; losing L of S leaves survivors
    whose rows compose their inclusion rate r with a second inclusion phase
    of rate 1/f, f = S/(S-L). The composed rate r/f gives HT weight f·w, so
    the weighted point leaves scale by f, and the per-row variance term

        (1-r')/r'² = f²(1-r)/r² + f(f-1)/r,

    so each variance leaf becomes f²·var + f(f-1)·(matching w-leaf of the
    survivors). f > 1 strictly grows every variance: degraded CIs are wider
    than the clean scan's. `n` counts surviving rows and is not reweighted.
    f, f² and f(f-1) are float32 scalars, as in the reference."""
    f = np.float32(factor)
    ff, g = float(f * f), float(f * (f - np.float32(1.0)))
    f = float(f)
    return GroupedMoments(
        n=mom.n,
        wsum=f * mom.wsum,
        wxsum=f * mom.wxsum,
        wx2sum=f * mom.wx2sum,
        var_count=ff * mom.var_count + g * mom.wsum,
        var_sum=ff * mom.var_sum + g * mom.wxsum,
        var_sum2=ff * mom.var_sum2 + g * mom.wx2sum)


def moments_finite(mom: GroupedMoments) -> bool:
    """True iff every statistic is finite: the detection boundary for a
    poisoned (NaN/Inf) shard partial, caught here before it reaches the
    cross-shard sum. One reduction over the seven leaves on their device,
    then one read of a bool."""
    return bool(torch.isfinite(mom.stacked()).all())


def moments_slice(mom: GroupedMoments, i: int) -> GroupedMoments:
    """Query i of a batched GroupedMoments (leaves [Q, G] → [G])."""
    return GroupedMoments(*(getattr(mom, f.name)[i]
                            for f in dataclasses.fields(GroupedMoments)))


def effective_sample_size(mom: GroupedMoments) -> torch.Tensor:
    """Kish effective sample size (Σw)²/Σw² per group; Σw² = var_count +
    wsum since each selected row contributes (1-r)/r² = w² - w."""
    w2sum = mom.var_count + mom.wsum
    return torch.where(w2sum > 0.0, mom.wsum * mom.wsum
                       / torch.clamp_min(w2sum, 1e-12),
                       torch.zeros_like(w2sum))


# Effective rows a QUANTILE estimate needs on its thin side (below q, or
# above it) before Table 2's normal approximation holds.
QUANTILE_MIN_TAIL_ROWS = 10.0


def quantile_sample_suffices(mom: GroupedMoments, q: float) -> bool:
    """Whether every group's sample can carry a closed-form CI for its
    q-quantile: n_eff · min(q, 1 - q) ≥ 10 (n_eff the Kish effective sample
    size: at least ten effective rows on the quantile's thin side, the
    usual condition for the normal approximation to a binomial count), or
    the sample holds the group whole (every rate 1, so its histogram is the
    population's). Below that floor a tail quantile is read off a handful
    of heavily weighted rows and its CI can be many times too narrow. The
    reference certifies without this floor."""
    n_eff = effective_sample_size(mom)
    whole = (mom.wsum - mom.n).abs() <= 1e-6 * torch.clamp_min(mom.wsum, 1.0)
    tail = n_eff * min(q, 1.0 - q) >= QUANTILE_MIN_TAIL_ROWS
    return bool((whole | tail).all())


def pilot_inflation(n_pilot, confidence: float):
    """Finite-sample variance inflation for a-priori certification: the
    (confidence)-upper limit of the true variance from a pilot of n rows,
    Var_up = S²·ν/χ²_{α,ν}, ν = n-1, via the Wilson–Hilferty approximation.
    Returns a factor ≥ 1 per group."""
    n = np.maximum(np.asarray(n_pilot, dtype=np.float64), 2.0)
    nu = n - 1.0
    z_lo = -z_value(max(2.0 * confidence - 1.0, 1e-9))  # = Φ⁻¹(1-conf) < 0
    h = 2.0 / (9.0 * nu)
    chi_lo = nu * np.maximum(1.0 - h + z_lo * np.sqrt(h), 1e-3) ** 3
    return np.maximum(nu / chi_lo, 1.0)


@dataclasses.dataclass
class Estimate:
    value: torch.Tensor     # f32[G] point estimates
    variance: torch.Tensor  # f32[G] estimator variance
    n: torch.Tensor         # f32[G] selected sample rows


def estimate(agg: AggOp, mom: GroupedMoments, *,
             quantile_value: torch.Tensor | None = None,
             quantile_density: torch.Tensor | None = None,
             q: float = 0.5) -> Estimate:
    """Point estimate + variance per group for a Table-2 aggregate. QUANTILE
    takes the histogram quantile and its density per group
    (executor.hist_to_quantile)."""
    eps = 1e-12
    if agg is AggOp.COUNT:
        # HT count: Σ 1/r_i ; Var = Σ (1-r)/r².
        return Estimate(mom.wsum, mom.var_count, mom.n)
    if agg is AggOp.SUM:
        return Estimate(mom.wxsum, mom.var_sum2, mom.n)
    if agg is AggOp.AVG:
        # Ratio estimator Σwx / Σw with the delta-method variance
        #   Var(Â) ≈ (Var(S) - 2Â Cov(S,C) + Â² Var(C)) / C²
        c = torch.clamp_min(mom.wsum, eps)
        a = mom.wxsum / c
        var = (mom.var_sum2 - 2.0 * a * mom.var_sum + a * a * mom.var_count) / (c * c)
        return Estimate(a, torch.clamp_min(var, 0.0), mom.n)
    if agg is AggOp.QUANTILE:
        # Table 2: Var = p(1-p) / (n f(x_p)²), f the histogram density at
        # the quantile and n the Kish effective sample size (Σw)²/Σw².
        if quantile_value is None or quantile_density is None:
            raise ValueError("QUANTILE needs quantile_value and "
                             "quantile_density")
        n = torch.clamp_min(effective_sample_size(mom), 1.0)
        f = torch.clamp_min(quantile_density, eps)
        # p(1-p) is a host double rounded to float32 once, as the reference
        # does (a Python scalar divided by a tensor would multiply by the
        # tensor's reciprocal instead).
        pq = torch.full_like(n, q * (1.0 - q))
        return Estimate(quantile_value, pq / (n * (f * f)), mom.n)
    raise ValueError(f"unsupported aggregate {agg}")


def required_n_for_error(agg: AggOp, est: Estimate, bound_eps: float,
                         confidence: float, relative: bool) -> torch.Tensor:
    """ELP error-profile projection (paper §4.2): selected rows n so the CI
    half-width meets the bound, from Var ∝ 1/n scaling of the probe."""
    z = z_value(confidence)
    if relative:
        target_var = torch.clamp_min((bound_eps * torch.abs(est.value) / z) ** 2,
                                     1e-30)
    else:   # a host scalar, rounded to float32 once (as the reference)
        target_var = torch.tensor(max((bound_eps / z) ** 2, 1e-30),
                                  dtype=torch.float32, device=est.n.device)
    cur_n = torch.clamp_min(est.n, 1.0)
    # Var(n) ≈ Var_probe · n_probe / n  ⇒  n_req = n_probe · Var_probe / Var_target
    return cur_n * est.variance / target_var


def ci(est: Estimate, confidence: float
       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    z = z_value(confidence)
    stderr = torch.sqrt(torch.clamp_min(est.variance, 0.0))
    return stderr, est.value - z * stderr, est.value + z * stderr


# ---------------------------------------------------------------------------
# Variational subsampling (VerdictDB): CIs from the same segment reductions
# ---------------------------------------------------------------------------
# The sample's rows are partitioned into B disjoint subsamples by a hash of
# their slot index. A scan with segment ids g·B + j (n_groups·B segments)
# yields per-(group, subsample) partial moments in ONE pass; the full-scan
# moments are the sums over the B axis. Each subsample is itself an HT
# sample with inclusion rate r_i/B, so B·(its HT total) estimates the
# population total; the spread of the B replicate estimates θ_j gives
# Var(θ̂) ≈ Var_j(θ_j)/B. Only these small [..., G, B] steps run as torch
# ops; the scan itself is a kernel launch (executor).

N_SUBSAMPLES = 32


def fold_subsamples(mom: GroupedMoments, n_groups: int,
                    n_subsamples: int) -> GroupedMoments:
    """[..., G·B] subsampled leaves → [..., G] full-scan moments (the B
    partial sums of each group added up)."""
    def fold(x):
        return x.reshape(*x.shape[:-1], n_groups, n_subsamples).sum(dim=-1)
    return GroupedMoments(*(fold(getattr(mom, f.name))
                            for f in dataclasses.fields(GroupedMoments)))


def subsample_replicates(agg: AggOp, mom: GroupedMoments, n_groups: int,
                         n_subsamples: int, *,
                         quantile_values: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(group, subsample) replicate estimates θ_j → (theta[..., G, B],
    valid[..., G, B]). COUNT/SUM totals are scaled by B (each subsample's HT
    rate is r/B); AVG is a scale-free ratio; QUANTILE replicates are the
    per-subsample histogram quantiles. Empty subsamples (no selected row)
    are masked out."""
    b = n_subsamples

    def rs(x):
        return x.reshape(*x.shape[:-1], n_groups, b)

    nsel, wsum, wxsum = rs(mom.n), rs(mom.wsum), rs(mom.wxsum)
    valid = nsel > 0.0
    if agg is AggOp.COUNT:
        theta = b * wsum
    elif agg is AggOp.SUM:
        theta = b * wxsum
    elif agg is AggOp.AVG:
        theta = wxsum / torch.clamp_min(wsum, 1e-12)
    elif agg is AggOp.QUANTILE:
        if quantile_values is None:
            raise ValueError("QUANTILE replicates need quantile_values")
        theta = rs(quantile_values)
    else:
        raise ValueError(f"unsupported aggregate {agg}")
    return theta, valid


def subsampling_variance(theta: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Var(θ̂) from the replicate spread: the sample variance of the θ_j over
    the non-empty subsamples, scaled by 1/B_valid. Groups with fewer than 2
    live replicates report 0 variance (no spread information)."""
    v = valid.to(theta.dtype)
    live = v.sum(dim=-1)
    bv = torch.clamp_min(live, 1.0)
    mean = (theta * v).sum(dim=-1) / bv
    dev2 = ((theta - mean[..., None]) ** 2) * v
    var_j = dev2.sum(dim=-1) / torch.clamp_min(bv - 1.0, 1.0)
    return torch.where(live > 1.0, var_j / bv, torch.zeros_like(var_j))


def subsampling_estimate(agg: AggOp, mom_sub: GroupedMoments, n_groups: int,
                         n_subsamples: int, *,
                         quantile_value: torch.Tensor | None = None,
                         quantile_density: torch.Tensor | None = None,
                         quantile_values_sub: torch.Tensor | None = None,
                         q: float = 0.5) -> Estimate:
    """Point estimate from the FOLDED moments (the plain scan's, up to the
    order of the sums) with the variance from the subsample replicate
    spread."""
    full = fold_subsamples(mom_sub, n_groups, n_subsamples)
    base = estimate(agg, full, quantile_value=quantile_value,
                    quantile_density=quantile_density, q=q)
    theta, valid = subsample_replicates(
        agg, mom_sub, n_groups, n_subsamples,
        quantile_values=quantile_values_sub)
    return Estimate(base.value, subsampling_variance(theta, valid), base.n)
