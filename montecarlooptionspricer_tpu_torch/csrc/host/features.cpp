// The port's native host feature engine (counterpart:
// montecarlooptionspricer_tpu's native/features.cpp, whose math this file
// keeps sum for sum).
//
// The PredictionGen host pass computes, once per option row on a history
// of at most 1825 points, the rough-Bergomi parameters with a windowed DFA
// Hurst estimate and the 20-day realized vol and momentum.  Everything is
// float64, variances take the n-1 denominator (the 20-day vol's the biased
// one), and every sum runs in the counterpart's order, so that under the
// same compiler flags (no -ffast-math, no -march=native) the results equal
// the counterpart's to the bit.  The NumPy forms beside it
// (ops/estimators.py estimate_params_plain, hurst_exponent_dfa_plain;
// pipeline/spot.py twenty_day_vol_and_momentum_plain) agree to ~1e-12.
//
// A CPython extension, built at first use by kernels/host_build.py:
//   estimate_params(prices, dt_yr=1/252) -> (s0, xi, h, eta, rho)
//   hurst_dfa(values) -> float
//   vol_momentum(history) -> (vol, momentum)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cmath>
#include <cstring>
#include <vector>

namespace {

// A float64 C-contiguous buffer is copied at once; any other sequence is
// read element by element as floats.
bool read_doubles(PyObject* obj, std::vector<double>* out) {
  Py_buffer view;
  if (PyObject_GetBuffer(obj, &view, PyBUF_CONTIG_RO | PyBUF_FORMAT) == 0) {
    const bool f64 = view.itemsize == sizeof(double) && view.format &&
                     std::strcmp(view.format, "d") == 0;
    if (f64) {
      const double* p = static_cast<const double*>(view.buf);
      out->assign(p, p + view.len / sizeof(double));
    }
    PyBuffer_Release(&view);
    if (f64) return true;
  } else {
    PyErr_Clear();
  }
  PyObject* seq = PySequence_Fast(obj, "expected a sequence of floats");
  if (!seq) return false;
  const Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  out->resize(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i) {
    const double v = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(seq, i));
    if (v == -1.0 && PyErr_Occurred()) {
      Py_DECREF(seq);
      return false;
    }
    (*out)[static_cast<size_t>(i)] = v;
  }
  Py_DECREF(seq);
  return true;
}

double mean(const std::vector<double>& v) {
  if (v.empty()) return 0.0;
  double s = 0.0;
  for (double x : v) s += x;
  return s / static_cast<double>(v.size());
}

// Sample variance, n-1 denominator; 0 below two points.
double variance(const std::vector<double>& v) {
  const size_t n = v.size();
  if (n < 2) return 0.0;
  const double m = mean(v);
  double s = 0.0;
  for (double x : v) s += (x - m) * (x - m);
  return s / static_cast<double>(n - 1);
}

// Sample covariance, n-1 denominator; 0 below two points.
double covariance(const std::vector<double>& x, const std::vector<double>& y) {
  const size_t n = x.size();
  if (n != y.size() || n < 2) return 0.0;
  const double mx = mean(x), my = mean(y);
  double s = 0.0;
  for (size_t i = 0; i < n; ++i) s += (x[i] - mx) * (y[i] - my);
  return s / static_cast<double>(n - 1);
}

// Subtract the least-squares line fitted against t = 1..n, in place.
void detrend(double* seg, size_t n) {
  if (n < 2) return;
  const double tm = (static_cast<double>(n) + 1.0) / 2.0;
  double ym = 0.0;
  for (size_t i = 0; i < n; ++i) ym += seg[i];
  ym /= static_cast<double>(n);
  double num = 0.0, den = 0.0;
  for (size_t i = 0; i < n; ++i) {
    const double t = static_cast<double>(i + 1);
    num += (t - tm) * (seg[i] - ym);
    den += (t - tm) * (t - tm);
  }
  if (std::fabs(den) < 1e-14) return;
  const double slope = num / den;
  const double intercept = ym - slope * tm;
  for (size_t i = 0; i < n; ++i)
    seg[i] -= slope * static_cast<double>(i + 1) + intercept;
}

// DFA: demean, cumulate, detrend in dyadic windows 4, 8, ..., n/4, then
// the log-log slope of the mean RMS fluctuation against the window size.
double hurst_dfa(const std::vector<double>& values) {
  const size_t n = values.size();
  if (n < 2) return 0.5;
  const double m = mean(values);
  std::vector<double> profile(n);
  double cum = 0.0;
  for (size_t i = 0; i < n; ++i) {
    cum += values[i] - m;
    profile[i] = cum;
  }
  std::vector<double> log_w, log_f, seg;
  for (size_t w = 4; w <= n / 4; w *= 2) {
    double fluct_sum = 0.0;
    size_t count = 0;
    for (size_t start = 0; start + w <= n; start += w) {
      seg.assign(profile.begin() + start, profile.begin() + start + w);
      detrend(seg.data(), w);
      double ss = 0.0;
      for (double x : seg) ss += x * x;
      fluct_sum += std::sqrt(ss / static_cast<double>(w));
      ++count;
    }
    const double mf = count ? fluct_sum / static_cast<double>(count) : 0.0;
    if (mf > 0.0) {
      log_w.push_back(std::log(static_cast<double>(w)));
      log_f.push_back(std::log(mf));
    }
  }
  const size_t k = log_w.size();
  if (k < 2) return 0.5;
  double sw = 0.0, sf = 0.0, swf = 0.0, sww = 0.0;
  for (size_t i = 0; i < k; ++i) {
    sw += log_w[i];
    sf += log_f[i];
    swf += log_w[i] * log_f[i];
    sww += log_w[i] * log_w[i];
  }
  const double dk = static_cast<double>(k);
  return (dk * swf - sw * sf) / (dk * sww - sw * sw);
}

PyObject* estimate_params_py(PyObject*, PyObject* args) {
  PyObject* obj = nullptr;
  double dt_yr = 1.0 / 252.0;
  if (!PyArg_ParseTuple(args, "O|d", &obj, &dt_yr)) return nullptr;
  std::vector<double> prices;
  if (!read_doubles(obj, &prices)) return nullptr;
  if (prices.size() < 2) {
    PyErr_SetString(PyExc_ValueError, "Historical prices vector too small.");
    return nullptr;
  }
  const size_t nr = prices.size() - 1;
  std::vector<double> rets(nr), sq(nr);
  for (size_t i = 0; i < nr; ++i) {
    rets[i] = std::log(prices[i + 1] / prices[i]);
    sq[i] = rets[i] * rets[i];
  }
  const double var = variance(rets);
  const double xi = var / dt_yr;
  const double h = hurst_dfa(rets);
  const double eta = 2.0 * std::sqrt(var);
  const double denom = std::sqrt(var * variance(sq));
  double rho = denom > 0.0 ? covariance(rets, sq) / denom : 0.0;
  if (rho > 0.0) rho = -0.3;
  return Py_BuildValue("(ddddd)", prices.back(), xi, h, eta, rho);
}

PyObject* hurst_dfa_py(PyObject*, PyObject* args) {
  PyObject* obj = nullptr;
  if (!PyArg_ParseTuple(args, "O", &obj)) return nullptr;
  std::vector<double> values;
  if (!read_doubles(obj, &values)) return nullptr;
  return PyFloat_FromDouble(hurst_dfa(values));
}

// The last 20 log returns: a return with a non-positive price or a
// non-finite log counts as 0; (0, 0) below 21 points.  The vol is the
// biased variance's root annualized by sqrt(252), the momentum the sum.
PyObject* vol_momentum_py(PyObject*, PyObject* args) {
  PyObject* obj = nullptr;
  if (!PyArg_ParseTuple(args, "O", &obj)) return nullptr;
  std::vector<double> hist;
  if (!read_doubles(obj, &hist)) return nullptr;
  if (hist.size() < 21) return Py_BuildValue("(dd)", 0.0, 0.0);
  const double* w = hist.data() + hist.size() - 21;
  double lr[20];
  double sum = 0.0;
  for (int i = 0; i < 20; ++i) {
    lr[i] = 0.0;
    if (w[i] > 0.0 && w[i + 1] > 0.0) {
      const double v = std::log(w[i + 1] / w[i]);
      if (std::isfinite(v)) lr[i] = v;
    }
    sum += lr[i];
  }
  const double m = sum / 20.0;
  double ss = 0.0;
  for (int i = 0; i < 20; ++i) ss += lr[i] * lr[i];
  double var = ss / 20.0 - m * m;
  if (var < 0.0) var = 0.0;
  return Py_BuildValue("(dd)", std::sqrt(var) * std::sqrt(252.0), sum);
}

PyMethodDef methods[] = {
    {"estimate_params", estimate_params_py, METH_VARARGS,
     "estimate_params(prices, dt_yr=1/252) -> (s0, xi, h, eta, rho)"},
    {"hurst_dfa", hurst_dfa_py, METH_VARARGS,
     "hurst_dfa(values) -> DFA Hurst exponent"},
    {"vol_momentum", vol_momentum_py, METH_VARARGS,
     "vol_momentum(history) -> (annualized 20-day vol, 20-day momentum)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module_def = {
    PyModuleDef_HEAD_INIT, "_mcop_features",
    "The port's host feature engine: DFA Hurst, rough-Bergomi parameters, "
    "20-day vol and momentum.",
    -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__mcop_features(void) {
  return PyModule_Create(&module_def);
}
