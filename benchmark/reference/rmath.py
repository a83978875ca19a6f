"""R-exact Poisson upper tail, ppois(x, lambda, lower.tail=FALSE): a frozen
copy of the program's pure-Python implementation of R's nmath algorithm
(ppois, pgamma, dpois, stirlerr, bd0, pnorm, dnorm; (C) The R Core Team /
Morten Welinder, GPL), in host float64 with libm transcendentals, without
its native batch. DADA2's abundance p-values are compared against
OMEGA_A = 1e-40, where a last-ulp difference can flip a decision, so the
reference keeps R's own algorithm rather than scipy's.
"""
from __future__ import annotations

import math

__all__ = ["ppois_upper", "pgamma_lower", "ppois_upper_vec"]


def ppois_upper_vec(xs, lams):
    """ppois_upper over arrays, one element at a time."""
    import numpy as np

    xs = np.ascontiguousarray(xs, dtype=np.float64)
    lams = np.ascontiguousarray(lams, dtype=np.float64)
    out = np.empty(len(xs))
    for i in range(len(xs)):
        out[i] = ppois_upper(xs[i], lams[i])
    return out

DBL_EPSILON = 2.220446049250313e-16
DBL_MIN = 2.2250738585072014e-308
M_LN2 = 0.6931471805599453094172321214582
M_LN_SQRT_2PI = 0.918938533204672741780329736406
M_1_SQRT_2PI = 0.398942280401432677939946059934
M_SQRT_32 = 5.656854249492380195206754896838
M_2PI = 6.283185307179586476925286766559
M_SQRT2 = 1.414213562373095048801688724210
# M_LN2 * DBL_MAX_EXP / DBL_EPSILON (nmath dpq.h M_cutoff)
M_CUTOFF = M_LN2 * 1024 / DBL_EPSILON
SCALEFACTOR = 4294967296.0 ** 8  # 2^256


# ---------------------------------------------------------------------------
# stirlerr(n) = log(n!) - log( sqrt(2*pi*n)*(n/e)^n )   [nmath stirlerr.c]
# ---------------------------------------------------------------------------

_S0 = 0.083333333333333333333        # 1/12
_S1 = 0.00277777777777777777778      # 1/360
_S2 = 0.00079365079365079365079365   # 1/1260
_S3 = 0.000595238095238095238095238  # 1/1680
_S4 = 0.0008417508417508417508417508  # 1/1188

_SFERR_HALVES = (
    0.0,                            # n=0 - wrong, placeholder only
    0.1534264097200273452913848,    # 0.5
    0.0810614667953272582196702,    # 1.0
    0.0548141210519176538961390,    # 1.5
    0.0413406959554092940938221,    # 2.0
    0.03316287351993628748511048,   # 2.5
    0.02767792568499833914878929,   # 3.0
    0.02374616365629749597132920,   # 3.5
    0.02079067210376509311152277,   # 4.0
    0.01848845053267318523077934,   # 4.5
    0.01664469118982119565398018,   # 5.0
    0.01513497322191737887351255,   # 5.5
    0.01387612882307074799874573,   # 6.0
    0.01281046524292022692424986,   # 6.5
    0.01189670994589177009505572,   # 7.0
    0.01110455975820691732662991,   # 7.5
    0.010411265261972096497478567,  # 8.0
    0.009799416126158803298389475,  # 8.5
    0.009255462182712732917728637,  # 9.0
    0.008768700134139385462952823,  # 9.5
    0.008330563433362871256469318,  # 10.0
    0.008079498749760810524,        # 10.5  (unused placeholder; see test)
    0.007573675487951840794972024,  # 11.0
    0.007244554301320383179543912,  # 11.5
    0.006942840107209529865664152,  # 12.0
    0.006665247032707682442354394,  # 12.5
    0.006408994188004207068439631,  # 13.0
    0.006171712263039457647532867,  # 13.5
    0.005951370112758847735624416,  # 14.0
    0.005746216513010115682023589,  # 14.5
    0.005554733551962801371038690,  # 15.0
)


def _stirlerr(n: float) -> float:
    if n <= 15.0:
        nn = n + n
        if nn == int(nn):
            return _SFERR_HALVES[int(nn)]
        return (math.lgamma(n + 1.0) - (n + 0.5) * math.log(n) + n
                - M_LN_SQRT_2PI)
    nn = n * n
    if n > 500:
        return (_S0 - _S1 / nn) / n
    if n > 80:
        return (_S0 - (_S1 - _S2 / nn) / nn) / n
    if n > 35:
        return (_S0 - (_S1 - (_S2 - _S3 / nn) / nn) / nn) / n
    return (_S0 - (_S1 - (_S2 - (_S3 - _S4 / nn) / nn) / nn) / nn) / n


# ---------------------------------------------------------------------------
# bd0(x, np) = x*log(x/np) + np - x, computed stably   [nmath bd0.c]
# ---------------------------------------------------------------------------

def _bd0(x: float, np_: float) -> float:
    if abs(x - np_) < 0.1 * (x + np_):
        v = (x - np_) / (x + np_)
        s = (x - np_) * v
        if abs(s) < DBL_MIN:
            return s
        ej = 2 * x * v
        v = v * v
        for j in range(1, 1000):
            ej *= v
            s1 = s + ej / (2 * j + 1)
            if s1 == s:
                return s1
            s = s1
    return x * math.log(x / np_) + np_ - x


# ---------------------------------------------------------------------------
# dpois_raw / dpois_wrap   [nmath dpois.c; pgamma.c dpois_wrap]
# ---------------------------------------------------------------------------

def _dpois_raw(x: float, lam: float, give_log: bool) -> float:
    if lam == 0:
        return (1.0 if x == 0 else 0.0) if not give_log else \
            (0.0 if x == 0 else -math.inf)
    if not math.isfinite(lam):
        return -math.inf if give_log else 0.0
    if x < 0:
        return -math.inf if give_log else 0.0
    if x <= lam * DBL_MIN:
        return -lam if give_log else math.exp(-lam)
    if lam < x * DBL_MIN:
        r = -lam + x * math.log(lam) - math.lgamma(x + 1)
        return r if give_log else math.exp(r)
    r = -_stirlerr(x) - _bd0(x, lam)
    f = M_2PI * x
    return (-0.5 * math.log(f) + r) if give_log else \
        (math.exp(r) / math.sqrt(f))


def _dpois_wrap(x_plus_1: float, lam: float, give_log: bool) -> float:
    if not math.isfinite(lam):
        return -math.inf if give_log else 0.0
    if x_plus_1 > 1:
        return _dpois_raw(x_plus_1 - 1, lam, give_log)
    if lam > abs(x_plus_1 - 1) * M_CUTOFF:
        r = -lam - math.lgamma(x_plus_1)
        return r if give_log else math.exp(r)
    d = _dpois_raw(x_plus_1, lam, give_log)
    return (d + math.log(x_plus_1 / lam)) if give_log else \
        (d * (x_plus_1 / lam))


# ---------------------------------------------------------------------------
# log1pmx, logcf   [nmath pgamma.c]
# ---------------------------------------------------------------------------

def _logcf(x: float, i: float, d: float, eps: float) -> float:
    c1 = 2 * d
    c2 = i + d
    c4 = c2 + d
    a1 = c2
    b1 = i * (c2 - i * x)
    b2 = d * d * x
    a2 = c4 * c2 - b2
    b2 = c4 * b1 - i * b2
    while abs(a2 * b1 - a1 * b2) > abs(eps * b1 * b2):
        c3 = c2 * c2 * x
        c2 += d
        c4 += d
        a1 = c4 * a2 - c3 * a1
        b1 = c4 * b2 - c3 * b1
        c3 = c1 * c1 * x
        c1 += d
        c4 += d
        a2 = c4 * a1 - c3 * a2
        b2 = c4 * b1 - c3 * b2
        if abs(b2) > SCALEFACTOR:
            a1 /= SCALEFACTOR
            b1 /= SCALEFACTOR
            a2 /= SCALEFACTOR
            b2 /= SCALEFACTOR
        elif abs(b2) < 1 / SCALEFACTOR:
            a1 *= SCALEFACTOR
            b1 *= SCALEFACTOR
            a2 *= SCALEFACTOR
            b2 *= SCALEFACTOR
    return a2 / b2


def _log1pmx(x: float) -> float:
    """log(1+x) - x, accurately also for small x."""
    minLog1Value = -0.79149064
    if x > 1 or x < minLog1Value:
        return math.log1p(x) - x
    # expand in [x/(2+x)]^2
    r = x / (2 + x)
    y = r * r
    if abs(x) < 1e-2:
        two = 2.0
        return r * ((((two / 9 * y + two / 7) * y + two / 5) * y
                     + two / 3) * y - x)
    tol_logcf = 1e-14
    return r * (2 * y * _logcf(y, 3, 2, tol_logcf) - x)


def _lgamma1p(a: float) -> float:
    """log(gamma(a+1)). Only reached with integer a >= 1 in this engine
    (shape = reads), where lgamma is exact; R's small-|a| Chebyshev
    branch is deliberately not needed (asserted)."""
    if abs(a) >= 0.5:
        return math.lgamma(a + 1)
    raise NotImplementedError("lgamma1p small-branch not needed: shape>=1")


# ---------------------------------------------------------------------------
# pgamma series/continued-fraction helpers   [nmath pgamma.c]
# ---------------------------------------------------------------------------

def _pgamma_smallx(x: float, alph: float, lower_tail: bool,
                   log_p: bool) -> float:
    sum_ = 0.0
    c = alph
    n = 0.0
    while True:
        n += 1
        c *= -x / n
        term = c / (alph + n)
        sum_ += term
        if not (abs(term) > DBL_EPSILON * abs(sum_)):
            break
    if lower_tail:
        f1 = math.log1p(sum_) if log_p else 1 + sum_
        if alph > 1:
            f2 = _dpois_raw(alph, x, log_p)
            f2 = (f2 + x) if log_p else (f2 * math.exp(x))
        elif log_p:
            f2 = alph * math.log(x) - _lgamma1p(alph)
        else:
            f2 = x ** alph / math.exp(_lgamma1p(alph))
        return (f1 + f2) if log_p else (f1 * f2)
    lf2 = alph * math.log(x) - _lgamma1p(alph)
    if log_p:
        return _log1_exp(math.log1p(sum_) + lf2)
    f1m1 = sum_
    f2m1 = math.expm1(lf2)
    return -(f1m1 + f2m1 + f1m1 * f2m1)


def _log1_exp(x: float) -> float:
    """log(1 - exp(x)), x <= 0   [dpq.h R_Log1_Exp]."""
    if x > -M_LN2:
        return math.log(-math.expm1(x))
    return math.log1p(-math.exp(x))


def _pd_upper_series(x: float, y: float, log_p: bool) -> float:
    term = x / y
    sum_ = term
    while True:
        y += 1
        term *= x / y
        sum_ += term
        if not (term > sum_ * DBL_EPSILON):
            break
    return math.log(sum_) if log_p else sum_


def _pd_lower_cf(y: float, d: float) -> float:
    if y == 0:
        return 0.0
    f0 = y / d
    if abs(y - 1) < abs(d) * DBL_EPSILON:
        return f0
    if f0 > 1.0:
        f0 = 1.0
    c2 = y
    c4 = d
    a1, b1 = 0.0, 1.0
    a2, b2 = y, d
    while b2 > SCALEFACTOR:
        a1 /= SCALEFACTOR
        b1 /= SCALEFACTOR
        a2 /= SCALEFACTOR
        b2 /= SCALEFACTOR
    i = 0.0
    of = -1.0
    f = 0.0
    while i < 200000:
        i += 1
        c2 -= 1
        c3 = i * c2
        c4 += 2
        a1 = c4 * a2 + c3 * a1
        b1 = c4 * b2 + c3 * b1
        i += 1
        c2 -= 1
        c3 = i * c2
        c4 += 2
        a2 = c4 * a1 + c3 * a2
        b2 = c4 * b1 + c3 * b2
        if b2 > SCALEFACTOR:
            a1 /= SCALEFACTOR
            b1 /= SCALEFACTOR
            a2 /= SCALEFACTOR
            b2 /= SCALEFACTOR
        if b2 != 0:
            f = a2 / b2
            if abs(f - of) <= DBL_EPSILON * max(f0, abs(f)):
                return f
            of = f
    return f  # non-convergence (should not happen)


def _pd_lower_series(lam: float, y: float) -> float:
    term = 1.0
    sum_ = 0.0
    while y >= 1 and term > sum_ * DBL_EPSILON:
        term *= y / lam
        sum_ += term
        y -= 1
    if y != math.floor(y):
        f = _pd_lower_cf(y, lam + 1 - y)
        sum_ += term * f
    return sum_


# ---------------------------------------------------------------------------
# dnorm / pnorm (Cody)   [nmath dnorm.c, pnorm.c]
# ---------------------------------------------------------------------------

def _dnorm(x: float) -> float:
    """Standard normal density, R's dnorm(x, 0, 1, log=FALSE)."""
    x = abs(x)
    if not math.isfinite(x):
        return 0.0
    if x >= 2 * math.sqrt(1.7976931348623157e308):
        return 0.0
    if x < 5:
        return M_1_SQRT_2PI * math.exp(-0.5 * x * x)
    # x >= 5: split x = x1 + x2 with x1 = round(x*2^16)/2^16 so that
    # x1*x1 is exact, avoiding cancellation (R >= 3.1 behavior)
    if x > math.sqrt(-2 * M_LN2 * (-1021 + 1 - 53)):
        return 0.0
    x1 = math.ldexp(round(math.ldexp(x, 16)), -16)
    x2 = x - x1
    return M_1_SQRT_2PI * (math.exp(-0.5 * x1 * x1)
                           * math.exp((-0.5 * x2 - x1) * x2))


_PN_A = (2.2352520354606839287, 161.02823106855587881,
         1067.6894854603709582, 18154.981253343561249,
         0.065682337918207449113)
_PN_B = (47.20258190468824187, 976.09855173777669322,
         10260.932208618978716, 45507.789335026729956)
_PN_C = (0.39894151208813466764, 8.8831497943883759412,
         93.506656132177855979, 597.27027639480026226,
         2494.5375852903726711, 6848.1904505362823326,
         11602.651437647350408, 9842.7148383839780218,
         1.0765576773720192317e-8)
_PN_D = (22.266688044328115691, 235.38790178262499861,
         1519.377599407554805, 6485.558298266760755,
         18615.571640885098091, 34900.952721145977266,
         38912.003286093271411, 19685.429676859990727)
_PN_P = (0.21589853405795699, 0.1274011611602473639,
         0.022235277870649807, 0.001421619193227893466,
         2.9112874951168792e-5, 0.02307344176494017303)
_PN_Q = (1.28426009614491121, 0.468238212480865118,
         0.0659881378689285515, 0.00378239633202758244,
         7.29751555083966205e-5)
_SIXTEN = 16.0


def _pnorm_both(x: float, i_tail: int, log_p: bool) -> tuple:
    """R's pnorm_both: returns (cum, ccum).

    i_tail 0=lower only, 1=upper only, 2=both (the unused one may be
    nan).  Exact structure of nmath/pnorm.c (Cody's ANORM algorithm).
    """
    a, b, c, d, p, q = _PN_A, _PN_B, _PN_C, _PN_D, _PN_P, _PN_Q
    cum = ccum = math.nan
    eps = DBL_EPSILON * 0.5
    lower = i_tail != 1
    upper = i_tail != 0
    y = abs(x)
    if y <= 0.67448975:
        xnum = xden = 0.0
        if y > eps:
            xsq = x * x
            xnum = a[4] * xsq
            xden = xsq
            for i in range(3):
                xnum = (xnum + a[i]) * xsq
                xden = (xden + b[i]) * xsq
        temp = x * (xnum + a[3]) / (xden + b[3])
        if lower:
            cum = 0.5 + temp
        if upper:
            ccum = 0.5 - temp
        if log_p:
            if lower:
                cum = math.log(cum)
            if upper:
                ccum = math.log(ccum)
        return cum, ccum

    def do_del_swap(X, temp):
        # do_del: cum = the SMALL tail prob exp(-X^2/2)*temp computed
        # with the split-square trick; then swap_tail for x > 0.
        xsq = math.trunc(X * _SIXTEN) / _SIXTEN
        del_ = (X - xsq) * (X + xsq)
        if log_p:
            cum_ = -xsq * xsq * 0.5 + -del_ * 0.5 + math.log(temp)
            ccum_ = math.nan
            if (lower and x > 0.0) or (upper and x <= 0.0):
                ccum_ = math.log1p(-math.exp(-xsq * xsq * 0.5)
                                   * math.exp(-del_ * 0.5) * temp)
        else:
            cum_ = math.exp(-xsq * xsq * 0.5) * math.exp(-del_ * 0.5) * temp
            ccum_ = 1.0 - cum_
        if x > 0.0:  # swap_tail: cum <-> ccum
            cum_, ccum_ = (ccum_ if lower else cum_), cum_
        return cum_, ccum_

    if y <= M_SQRT_32:
        # 0.674.. < |x| <= sqrt(32) ~= 5.657
        xnum = c[8] * y
        xden = y
        for i in range(7):
            xnum = (xnum + c[i]) * y
            xden = (xden + d[i]) * y
        temp = (xnum + c[7]) / (xden + d[7])
        return do_del_swap(y, temp)
    if (log_p and y < 1e170) or \
            (lower and -37.5193 < x < 8.2924) or \
            (upper and -8.2924 < x < 37.5193):
        # |x| > sqrt(32)
        xsq = 1.0 / (x * x)
        xnum = p[5] * xsq
        xden = xsq
        for i in range(4):
            xnum = (xnum + p[i]) * xsq
            xden = (xden + q[i]) * xsq
        temp = xsq * (xnum + p[4]) / (xden + q[4])
        temp = (M_1_SQRT_2PI - temp) / y
        return do_del_swap(abs(x), temp)
    if x > 0:
        cum, ccum = (0.0, -math.inf) if log_p else (1.0, 0.0)
    else:
        cum, ccum = (-math.inf, 0.0) if log_p else (0.0, 1.0)
    return cum, ccum


def _pnorm(x: float, lower_tail: bool, log_p: bool) -> float:
    cum, ccum = _pnorm_both(x, 1 - int(lower_tail), log_p)
    return cum if lower_tail else ccum


# ---------------------------------------------------------------------------
# ppois_asymp + dpnorm   [nmath pgamma.c]
# ---------------------------------------------------------------------------

def _dpnorm(x: float, lower_tail: bool, lp: float) -> float:
    """dnorm(x)/pnorm(x) given lp = log pnorm(x, lower_tail)."""
    if x < 0:
        x = -x
        lower_tail = not lower_tail
    if x > 10 and not lower_tail:
        term = 1 / x
        sum_ = term
        x2 = x * x
        i = 1.0
        while True:
            term *= -i / x2
            sum_ += term
            i += 2
            if not (abs(term) > DBL_EPSILON * sum_):
                break
        return 1 / sum_
    d = _dnorm(x)
    return d / math.exp(lp)


_ASYMP_A = (-1e99, 2 / 3., -4 / 135., 8 / 2835., 16 / 8505.,
            -8992 / 12629925., -334144 / 492567075., 698752 / 1477701225.)
_ASYMP_B = (-1e99, 1 / 12., 1 / 288., -139 / 51840., -571 / 2488320.,
            163879 / 209018880., 5246819 / 75246796800.,
            -534703531 / 902961561600.)


def _ppois_asymp(x: float, lam: float, lower_tail: bool,
                 log_p: bool) -> float:
    """Asymptotic expansion for the Poisson cdf, x >= 1 near lam
    (Abramowitz & Stegun 26.4.14-style; nmath pgamma.c ppois_asymp)."""
    dfm = lam - x
    pt_ = -_log1pmx(dfm / x)
    s2pt = math.sqrt(2 * x * pt_)
    if dfm < 0:
        s2pt = -s2pt

    elfb = x
    elfb_term = 1.0
    for i in range(1, 8):
        elfb += elfb_term * _ASYMP_B[i]
        elfb_term /= x
    if not lower_tail:
        elfb = -elfb

    res12 = 0.0
    res1_ig = res1_term = math.sqrt(x)
    res2_ig = res2_term = s2pt
    for i in range(1, 8):
        res12 += res1_ig * _ASYMP_A[i]
        res12 += res2_ig * _ASYMP_B[i]
        res1_term *= pt_ / i
        res2_term *= 2 * pt_ / (2 * i + 1)
        res1_ig = res1_ig / x + res1_term
        res2_ig = res2_ig / x + res2_term

    f = res12 / elfb
    np_ = _pnorm(s2pt, not lower_tail, log_p)
    if log_p:
        n_d_over_p = _dpnorm(s2pt, not lower_tail, np_)
        return np_ + math.log1p(f * n_d_over_p)
    nd = _dnorm(s2pt)
    return np_ + f * nd


# ---------------------------------------------------------------------------
# pgamma_raw / pgamma / ppois   [nmath pgamma.c, ppois.c]
# ---------------------------------------------------------------------------

def _pgamma_raw(x: float, alph: float, lower_tail: bool,
                log_p: bool) -> float:
    # R_P_bounds_01(x, 0., +Inf)
    if x <= 0:
        return (0.0 if lower_tail else 1.0) if not log_p else \
            (-math.inf if lower_tail else 0.0)
    if x == math.inf:
        return (1.0 if lower_tail else 0.0) if not log_p else \
            (0.0 if lower_tail else -math.inf)

    if x < 1:
        res = _pgamma_smallx(x, alph, lower_tail, log_p)
    elif x <= alph - 1 and x < 0.8 * (alph + 50):
        # incl. large alph compared to x
        sum_ = _pd_upper_series(x, alph, log_p)  # = x/alph + o(x/alph)
        d = _dpois_wrap(alph, x, log_p)
        if not lower_tail:
            res = _log1_exp(d + sum_) if log_p else 1 - d * sum_
        else:
            res = (sum_ + d) if log_p else sum_ * d
    elif alph - 1 < x and alph < 0.8 * (x + 50):
        # incl. large x compared to alph
        d = _dpois_wrap(alph, x, log_p)
        if alph < 1:
            if x * DBL_EPSILON > 1 - alph:
                sum_ = 0.0 if log_p else 1.0  # R_D__1
            else:
                f = _pd_lower_cf(alph, x - (alph - 1)) * x / alph
                sum_ = math.log(f) if log_p else f
        else:
            sum_ = _pd_lower_series(x, alph - 1)  # = (alph-1)/x + o(..)
            sum_ = math.log1p(sum_) if log_p else 1 + sum_
        if not lower_tail:
            res = (sum_ + d) if log_p else sum_ * d
        else:
            res = _log1_exp(d + sum_) if log_p else 1 - d * sum_
    else:
        # x >= 1 and x fairly near alph
        res = _ppois_asymp(alph - 1, x, not lower_tail, log_p)

    # Redo in log space when the result is close enough to DBL_MIN that
    # underflow cost accuracy (nmath pgamma.c: DBL_MIN / DBL_EPSILON).
    if not log_p and res < DBL_MIN / DBL_EPSILON:
        return math.exp(_pgamma_raw(x, alph, lower_tail, True))
    return res


def pgamma_lower(q: float, shape: float) -> float:
    """R's pgamma(q, shape, scale=1, lower.tail=TRUE, log.p=FALSE)."""
    if shape == 0:
        return 1.0 if q > 0 else 0.0
    return _pgamma_raw(q, shape, True, False)


def ppois_upper(x: int, lam: float) -> float:
    """R's ppois(x, lam, lower.tail=FALSE): P(X > x), X ~ Poisson(lam).

    reference: src/pval.cpp:49-51 calls Rcpp::ppois(reads-1, E, false);
    R's ppois is pgamma(lam, x+1, 1, !lower_tail) after flooring x.
    """
    if lam < 0:
        return math.nan
    if x < 0:
        return 1.0
    if lam == 0:
        return 0.0
    xf = math.floor(x + 1e-7)
    return _pgamma_raw(lam, xf + 1, True, False)
