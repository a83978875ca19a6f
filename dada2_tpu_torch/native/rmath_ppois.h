// R-exact Poisson upper tail for the reference-parity harness: a C++
// twin of dada2_tpu_torch/utils/rmath.py (same published R nmath algorithm —
// ppois/pgamma/dpois/stirlerr/bd0/pnorm/dnorm, (C) The R Core Team /
// Morten Welinder, GPL — reimplemented expression-for-expression so the
// compiled reference engine computes p-values EXACTLY as the engine
// under test does, with no equalizing hook; the reference documents
// this math at the reference src/pval.cpp:44-64 and :199-339).
// Bit-identity of this header vs the Python module is fuzzed in
// tests/test_rmath.py.
#pragma once
#include <cfloat>
#include <cmath>

namespace dada2_rmath {

static const double kLn2 = 0.6931471805599453094172321214582;
static const double kLnSqrt2Pi = 0.918938533204672741780329736406;
static const double kOneOverSqrt2Pi = 0.398942280401432677939946059934;
static const double kSqrt32 = 5.656854249492380195206754896838;
static const double kTwoPi = 6.283185307179586476925286766559;
static const double kMCutoff = kLn2 * 1024 / DBL_EPSILON;
static const double kScaleFactor =
    1.157920892373161954235709850086879078532699846656405640394575840079131e77;  // 2^256

// ---- stirlerr ----------------------------------------------------------
static const double kSferrHalves[31] = {
    0.0,
    0.1534264097200273452913848,
    0.0810614667953272582196702,
    0.0548141210519176538961390,
    0.0413406959554092940938221,
    0.03316287351993628748511048,
    0.02767792568499833914878929,
    0.02374616365629749597132920,
    0.02079067210376509311152277,
    0.01848845053267318523077934,
    0.01664469118982119565398018,
    0.01513497322191737887351255,
    0.01387612882307074799874573,
    0.01281046524292022692424986,
    0.01189670994589177009505572,
    0.01110455975820691732662991,
    0.010411265261972096497478567,
    0.009799416126158803298389475,
    0.009255462182712732917728637,
    0.008768700134139385462952823,
    0.008330563433362871256469318,
    0.008079498749760810524,  // 10.5 placeholder, matches rmath.py
    0.007573675487951840794972024,
    0.007244554301320383179543912,
    0.006942840107209529865664152,
    0.006665247032707682442354394,
    0.006408994188004207068439631,
    0.006171712263039457647532867,
    0.005951370112758847735624416,
    0.005746216513010115682023589,
    0.005554733551962801371038690,
};

inline double stirlerr(double n) {
  const double S0 = 0.083333333333333333333;
  const double S1 = 0.00277777777777777777778;
  const double S2 = 0.00079365079365079365079365;
  const double S3 = 0.000595238095238095238095238;
  const double S4 = 0.0008417508417508417508417508;
  if (n <= 15.0) {
    double nn = n + n;
    if (nn == (int)nn) return kSferrHalves[(int)nn];
    return std::lgamma(n + 1.0) - (n + 0.5) * std::log(n) + n - kLnSqrt2Pi;
  }
  double nn = n * n;
  if (n > 500) return (S0 - S1 / nn) / n;
  if (n > 80) return (S0 - (S1 - S2 / nn) / nn) / n;
  if (n > 35) return (S0 - (S1 - (S2 - S3 / nn) / nn) / nn) / n;
  return (S0 - (S1 - (S2 - (S3 - S4 / nn) / nn) / nn) / nn) / n;
}

// ---- bd0 ---------------------------------------------------------------
inline double bd0(double x, double np) {
  if (std::fabs(x - np) < 0.1 * (x + np)) {
    double v = (x - np) / (x + np);
    double s = (x - np) * v;
    if (std::fabs(s) < DBL_MIN) return s;
    double ej = 2 * x * v;
    v = v * v;
    for (int j = 1; j < 1000; j++) {
      ej *= v;
      double s1 = s + ej / (2 * j + 1);
      if (s1 == s) return s1;
      s = s1;
    }
  }
  return x * std::log(x / np) + np - x;
}

// ---- dpois_raw / dpois_wrap --------------------------------------------
inline double dpois_raw(double x, double lam, bool give_log) {
  if (lam == 0)
    return give_log ? (x == 0 ? 0.0 : -INFINITY) : (x == 0 ? 1.0 : 0.0);
  if (!std::isfinite(lam)) return give_log ? -INFINITY : 0.0;
  if (x < 0) return give_log ? -INFINITY : 0.0;
  if (x <= lam * DBL_MIN) return give_log ? -lam : std::exp(-lam);
  if (lam < x * DBL_MIN) {
    double r = -lam + x * std::log(lam) - std::lgamma(x + 1);
    return give_log ? r : std::exp(r);
  }
  double r = -stirlerr(x) - bd0(x, lam);
  double f = kTwoPi * x;
  return give_log ? (-0.5 * std::log(f) + r) : (std::exp(r) / std::sqrt(f));
}

inline double dpois_wrap(double x_plus_1, double lam, bool give_log) {
  if (!std::isfinite(lam)) return give_log ? -INFINITY : 0.0;
  if (x_plus_1 > 1) return dpois_raw(x_plus_1 - 1, lam, give_log);
  if (lam > std::fabs(x_plus_1 - 1) * kMCutoff) {
    double r = -lam - std::lgamma(x_plus_1);
    return give_log ? r : std::exp(r);
  }
  double d = dpois_raw(x_plus_1, lam, give_log);
  return give_log ? (d + std::log(x_plus_1 / lam)) : (d * (x_plus_1 / lam));
}

// ---- log1pmx / logcf ----------------------------------------------------
inline double logcf(double x, double i, double d, double eps) {
  double c1 = 2 * d;
  double c2 = i + d;
  double c4 = c2 + d;
  double a1 = c2;
  double b1 = i * (c2 - i * x);
  double b2 = d * d * x;
  double a2 = c4 * c2 - b2;
  b2 = c4 * b1 - i * b2;
  while (std::fabs(a2 * b1 - a1 * b2) > std::fabs(eps * b1 * b2)) {
    double c3 = c2 * c2 * x;
    c2 += d;
    c4 += d;
    a1 = c4 * a2 - c3 * a1;
    b1 = c4 * b2 - c3 * b1;
    c3 = c1 * c1 * x;
    c1 += d;
    c4 += d;
    a2 = c4 * a1 - c3 * a2;
    b2 = c4 * b1 - c3 * b2;
    if (std::fabs(b2) > kScaleFactor) {
      a1 /= kScaleFactor;
      b1 /= kScaleFactor;
      a2 /= kScaleFactor;
      b2 /= kScaleFactor;
    } else if (std::fabs(b2) < 1 / kScaleFactor) {
      a1 *= kScaleFactor;
      b1 *= kScaleFactor;
      a2 *= kScaleFactor;
      b2 *= kScaleFactor;
    }
  }
  return a2 / b2;
}

inline double log1pmx(double x) {
  const double minLog1Value = -0.79149064;
  if (x > 1 || x < minLog1Value) return std::log1p(x) - x;
  double r = x / (2 + x);
  double y = r * r;
  if (std::fabs(x) < 1e-2) {
    const double two = 2.0;
    return r * ((((two / 9 * y + two / 7) * y + two / 5) * y + two / 3) * y -
                x);
  }
  const double tol_logcf = 1e-14;
  return r * (2 * y * logcf(y, 3, 2, tol_logcf) - x);
}

inline double lgamma1p(double a) {
  // only reached with a >= 1 in this engine (shape = reads)
  return std::lgamma(a + 1);
}

// ---- series helpers -----------------------------------------------------
inline double log1_exp(double x) {
  if (x > -kLn2) return std::log(-std::expm1(x));
  return std::log1p(-std::exp(x));
}

inline double pgamma_smallx(double x, double alph, bool lower_tail,
                            bool log_p) {
  double sum = 0.0, c = alph, n = 0.0, term;
  do {
    n += 1;
    c *= -x / n;
    term = c / (alph + n);
    sum += term;
  } while (std::fabs(term) > DBL_EPSILON * std::fabs(sum));
  if (lower_tail) {
    double f1 = log_p ? std::log1p(sum) : 1 + sum;
    double f2;
    if (alph > 1) {
      f2 = dpois_raw(alph, x, log_p);
      f2 = log_p ? f2 + x : f2 * std::exp(x);
    } else if (log_p) {
      f2 = alph * std::log(x) - lgamma1p(alph);
    } else {
      f2 = std::pow(x, alph) / std::exp(lgamma1p(alph));
    }
    return log_p ? f1 + f2 : f1 * f2;
  }
  double lf2 = alph * std::log(x) - lgamma1p(alph);
  if (log_p) return log1_exp(std::log1p(sum) + lf2);
  double f1m1 = sum;
  double f2m1 = std::expm1(lf2);
  return -(f1m1 + f2m1 + f1m1 * f2m1);
}

inline double pd_upper_series(double x, double y, bool log_p) {
  double term = x / y;
  double sum = term;
  do {
    y += 1;
    term *= x / y;
    sum += term;
  } while (term > sum * DBL_EPSILON);
  return log_p ? std::log(sum) : sum;
}

inline double pd_lower_cf(double y, double d) {
  if (y == 0) return 0.0;
  double f0 = y / d;
  if (std::fabs(y - 1) < std::fabs(d) * DBL_EPSILON) return f0;
  if (f0 > 1.0) f0 = 1.0;
  double c2 = y;
  double c4 = d;
  double a1 = 0.0, b1 = 1.0;
  double a2 = y, b2 = d;
  while (b2 > kScaleFactor) {
    a1 /= kScaleFactor;
    b1 /= kScaleFactor;
    a2 /= kScaleFactor;
    b2 /= kScaleFactor;
  }
  double i = 0.0, of = -1.0, f = 0.0;
  while (i < 200000) {
    i += 1;
    c2 -= 1;
    double c3 = i * c2;
    c4 += 2;
    a1 = c4 * a2 + c3 * a1;
    b1 = c4 * b2 + c3 * b1;
    i += 1;
    c2 -= 1;
    c3 = i * c2;
    c4 += 2;
    a2 = c4 * a1 + c3 * a2;
    b2 = c4 * b1 + c3 * b2;
    if (b2 > kScaleFactor) {
      a1 /= kScaleFactor;
      b1 /= kScaleFactor;
      a2 /= kScaleFactor;
      b2 /= kScaleFactor;
    }
    if (b2 != 0) {
      f = a2 / b2;
      if (std::fabs(f - of) <=
          DBL_EPSILON * (f0 > std::fabs(f) ? f0 : std::fabs(f)))
        return f;
      of = f;
    }
  }
  return f;
}

inline double pd_lower_series(double lam, double y) {
  double term = 1.0, sum = 0.0;
  while (y >= 1 && term > sum * DBL_EPSILON) {
    term *= y / lam;
    sum += term;
    y -= 1;
  }
  if (y != std::floor(y)) {
    double f = pd_lower_cf(y, lam + 1 - y);
    sum += term * f;
  }
  return sum;
}

// ---- dnorm / pnorm (Cody) -----------------------------------------------
inline double dnorm_std(double x) {
  x = std::fabs(x);
  if (!std::isfinite(x)) return 0.0;
  if (x >= 2 * std::sqrt(DBL_MAX)) return 0.0;
  if (x < 5) return kOneOverSqrt2Pi * std::exp(-0.5 * x * x);
  if (x > std::sqrt(-2 * kLn2 * (-1021 + 1 - 53))) return 0.0;
  double x1 = std::ldexp(std::nearbyint(std::ldexp(x, 16)), -16);
  double x2 = x - x1;
  return kOneOverSqrt2Pi *
         (std::exp(-0.5 * x1 * x1) * std::exp((-0.5 * x2 - x1) * x2));
}

static const double kPnA[5] = {2.2352520354606839287, 161.02823106855587881,
                               1067.6894854603709582, 18154.981253343561249,
                               0.065682337918207449113};
static const double kPnB[4] = {47.20258190468824187, 976.09855173777669322,
                               10260.932208618978716, 45507.789335026729956};
static const double kPnC[9] = {
    0.39894151208813466764, 8.8831497943883759412, 93.506656132177855979,
    597.27027639480026226,  2494.5375852903726711, 6848.1904505362823326,
    11602.651437647350408,  9842.7148383839780218, 1.0765576773720192317e-8};
static const double kPnD[8] = {
    22.266688044328115691, 235.38790178262499861, 1519.377599407554805,
    6485.558298266760755,  18615.571640885098091, 34900.952721145977266,
    38912.003286093271411, 19685.429676859990727};
static const double kPnP[6] = {0.21589853405795699,    0.1274011611602473639,
                               0.022235277870649807,   0.001421619193227893466,
                               2.9112874951168792e-5,  0.02307344176494017303};
static const double kPnQ[5] = {1.28426009614491121,    0.468238212480865118,
                               0.0659881378689285515,  0.00378239633202758244,
                               7.29751555083966205e-5};

inline void pnorm_both(double x, double *cum, double *ccum, int i_tail,
                       bool log_p) {
  const double *a = kPnA, *b = kPnB, *c = kPnC, *d = kPnD, *p = kPnP,
               *q = kPnQ;
  const double SIXTEN = 16.0;
  double xden, xnum, temp, del, xsq;
  double eps = DBL_EPSILON * 0.5;
  bool lower = i_tail != 1;
  bool upper = i_tail != 0;
  double y = std::fabs(x);
  if (y <= 0.67448975) {
    xnum = xden = 0.0;
    if (y > eps) {
      xsq = x * x;
      xnum = a[4] * xsq;
      xden = xsq;
      for (int i = 0; i < 3; ++i) {
        xnum = (xnum + a[i]) * xsq;
        xden = (xden + b[i]) * xsq;
      }
    }
    temp = x * (xnum + a[3]) / (xden + b[3]);
    if (lower) *cum = 0.5 + temp;
    if (upper) *ccum = 0.5 - temp;
    if (log_p) {
      if (lower) *cum = std::log(*cum);
      if (upper) *ccum = std::log(*ccum);
    }
    return;
  }

#define DADA2_RMATH_DO_DEL(X)                                              \
  xsq = std::trunc((X)*SIXTEN) / SIXTEN;                                   \
  del = ((X)-xsq) * ((X) + xsq);                                           \
  if (log_p) {                                                             \
    *cum = -xsq * xsq * 0.5 + -del * 0.5 + std::log(temp);                 \
    if ((lower && x > 0.) || (upper && x <= 0.))                           \
      *ccum = std::log1p(-std::exp(-xsq * xsq * 0.5) *                     \
                         std::exp(-del * 0.5) * temp);                     \
  } else {                                                                 \
    *cum = std::exp(-xsq * xsq * 0.5) * std::exp(-del * 0.5) * temp;       \
    *ccum = 1.0 - *cum;                                                    \
  }

#define DADA2_RMATH_SWAP_TAIL                                              \
  if (x > 0.) {                                                            \
    temp = *cum;                                                           \
    if (lower) *cum = *ccum;                                               \
    *ccum = temp;                                                          \
  }

  if (y <= kSqrt32) {
    xnum = c[8] * y;
    xden = y;
    for (int i = 0; i < 7; ++i) {
      xnum = (xnum + c[i]) * y;
      xden = (xden + d[i]) * y;
    }
    temp = (xnum + c[7]) / (xden + d[7]);
    DADA2_RMATH_DO_DEL(y)
    DADA2_RMATH_SWAP_TAIL
  } else if ((log_p && y < 1e170) || (lower && -37.5193 < x && x < 8.2924) ||
             (upper && -8.2924 < x && x < 37.5193)) {
    xsq = 1.0 / (x * x);
    xnum = p[5] * xsq;
    xden = xsq;
    for (int i = 0; i < 4; ++i) {
      xnum = (xnum + p[i]) * xsq;
      xden = (xden + q[i]) * xsq;
    }
    temp = xsq * (xnum + p[4]) / (xden + q[4]);
    temp = (kOneOverSqrt2Pi - temp) / y;
    DADA2_RMATH_DO_DEL(std::fabs(x))
    DADA2_RMATH_SWAP_TAIL
  } else {
    if (x > 0) {
      *cum = log_p ? 0.0 : 1.0;
      *ccum = log_p ? -INFINITY : 0.0;
    } else {
      *cum = log_p ? -INFINITY : 0.0;
      *ccum = log_p ? 0.0 : 1.0;
    }
  }
#undef DADA2_RMATH_DO_DEL
#undef DADA2_RMATH_SWAP_TAIL
}

inline double pnorm_std(double x, bool lower_tail, bool log_p) {
  double cum = NAN, ccum = NAN;
  pnorm_both(x, &cum, &ccum, lower_tail ? 0 : 1, log_p);
  return lower_tail ? cum : ccum;
}

// ---- ppois_asymp --------------------------------------------------------
inline double dpnorm(double x, bool lower_tail, double lp) {
  if (x < 0) {
    x = -x;
    lower_tail = !lower_tail;
  }
  if (x > 10 && !lower_tail) {
    double term = 1 / x;
    double sum = term;
    double x2 = x * x;
    double i = 1.0;
    do {
      term *= -i / x2;
      sum += term;
      i += 2;
    } while (std::fabs(term) > DBL_EPSILON * sum);
    return 1 / sum;
  }
  double d = dnorm_std(x);
  return d / std::exp(lp);
}

static const double kAsympA[8] = {-1e99,
                                  2 / 3.,
                                  -4 / 135.,
                                  8 / 2835.,
                                  16 / 8505.,
                                  -8992 / 12629925.,
                                  -334144 / 492567075.,
                                  698752 / 1477701225.};
static const double kAsympB[8] = {-1e99,
                                  1 / 12.,
                                  1 / 288.,
                                  -139 / 51840.,
                                  -571 / 2488320.,
                                  163879 / 209018880.,
                                  5246819 / 75246796800.,
                                  -534703531 / 902961561600.};

inline double ppois_asymp(double x, double lam, bool lower_tail,
                          bool log_p) {
  double dfm = lam - x;
  double pt_ = -log1pmx(dfm / x);
  double s2pt = std::sqrt(2 * x * pt_);
  if (dfm < 0) s2pt = -s2pt;

  double elfb = x;
  double elfb_term = 1.0;
  for (int i = 1; i < 8; i++) {
    elfb += elfb_term * kAsympB[i];
    elfb_term /= x;
  }
  if (!lower_tail) elfb = -elfb;

  double res12 = 0.0;
  double res1_ig, res1_term, res2_ig, res2_term;
  res1_ig = res1_term = std::sqrt(x);
  res2_ig = res2_term = s2pt;
  for (int i = 1; i < 8; i++) {
    res12 += res1_ig * kAsympA[i];
    res12 += res2_ig * kAsympB[i];
    res1_term *= pt_ / i;
    res2_term *= 2 * pt_ / (2 * i + 1);
    res1_ig = res1_ig / x + res1_term;
    res2_ig = res2_ig / x + res2_term;
  }

  double f = res12 / elfb;
  double np = pnorm_std(s2pt, !lower_tail, log_p);
  if (log_p) {
    double n_d_over_p = dpnorm(s2pt, !lower_tail, np);
    return np + std::log1p(f * n_d_over_p);
  }
  double nd = dnorm_std(s2pt);
  return np + f * nd;
}

// ---- pgamma_raw / ppois -------------------------------------------------
inline double pgamma_raw(double x, double alph, bool lower_tail,
                         bool log_p) {
  double res;
  if (x <= 0)
    return log_p ? (lower_tail ? -INFINITY : 0.0) : (lower_tail ? 0.0 : 1.0);
  if (x == INFINITY)
    return log_p ? (lower_tail ? 0.0 : -INFINITY) : (lower_tail ? 1.0 : 0.0);

  if (x < 1) {
    res = pgamma_smallx(x, alph, lower_tail, log_p);
  } else if (x <= alph - 1 && x < 0.8 * (alph + 50)) {
    double sum = pd_upper_series(x, alph, log_p);
    double d = dpois_wrap(alph, x, log_p);
    if (!lower_tail)
      res = log_p ? log1_exp(d + sum) : 1 - d * sum;
    else
      res = log_p ? sum + d : sum * d;
  } else if (alph - 1 < x && alph < 0.8 * (x + 50)) {
    double sum;
    double d = dpois_wrap(alph, x, log_p);
    if (alph < 1) {
      if (x * DBL_EPSILON > 1 - alph)
        sum = log_p ? 0.0 : 1.0;
      else {
        double f = pd_lower_cf(alph, x - (alph - 1)) * x / alph;
        sum = log_p ? std::log(f) : f;
      }
    } else {
      sum = pd_lower_series(x, alph - 1);
      sum = log_p ? std::log1p(sum) : 1 + sum;
    }
    if (!lower_tail)
      res = log_p ? sum + d : sum * d;
    else
      res = log_p ? log1_exp(d + sum) : 1 - d * sum;
  } else {
    res = ppois_asymp(alph - 1, x, !lower_tail, log_p);
  }

  if (!log_p && res < DBL_MIN / DBL_EPSILON)
    return std::exp(pgamma_raw(x, alph, lower_tail, true));
  return res;
}

// R's ppois(x, lam, lower.tail=FALSE): P(X > x), X ~ Poisson(lam).
inline double ppois_upper(double x, double lam) {
  if (lam < 0) return NAN;
  if (x < 0) return 1.0;
  if (lam == 0) return 0.0;
  double xf = std::floor(x + 1e-7);
  return pgamma_raw(lam, xf + 1, true, false);
}

}  // namespace dada2_rmath
