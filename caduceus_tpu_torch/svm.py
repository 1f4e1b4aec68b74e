"""VEP's classifier without scikit-learn: a standard scaler and an RBF
support-vector classifier in plain torch, on an explicit device.

The counterparts of the scikit-learn pieces that `caduceus_tpu/vep.py:
202-277` fits (the AUROC is `train/metrics.py roc_auc`):

- `StandardScaler`: the mean and the population standard deviation of
  each feature; a feature scikit-learn takes for constant (its variance
  within the rounding bound of a two-pass variance, which includes 0)
  keeps a scale of 1.
- `SVC`: the C-SVC of libsvm with the RBF kernel K(a, b) = exp(-gamma
  |a - b|^2) and scikit-learn's default ``gamma="scale"``: 1 / (n_features
  x the variance of every entry of the fit matrix). Its dual, min 1/2
  a'Qa - e'a over 0 <= a <= C with y'a = 0 and Q_ij = y_i y_j K_ij, is
  solved by SMO with libsvm's
  second-order working-set selection (Fan, Chen & Lin, JMLR 2005): i the
  maximal violator in I_up, j the pair with the largest second-order
  decrease in I_low (a curvature <= 0 taken as tau = 1e-12), stopping
  once the maximal violating pair's gap m(a) - M(a) is <= ``tol``; the
  intercept is libsvm's (the mean of y_i G_i over the free support
  vectors, else the midpoint of its bounds). ``decision_function`` is
  positive for ``classes_[1]``, as scikit-learn's binary SVC.

Everything is float64. The Gram matrix stays on the device while its 8 n^2
bytes fit in `GRAM_BUDGET_BYTES` (it is built in place, so the budget is
also the peak); past that budget each iteration computes the two kernel
rows it needs from the features, which stay on the device.
The selection and the update of an iteration are tensor operations on the
device (no host sync); the host reads the stopping flag every
`CHECK_EVERY` iterations, and the iterations after a stop change nothing.
On a card those `CHECK_EVERY` iterations (about 45 small launches each,
whose host cost would set the pace) are captured once as a CUDA graph and
replayed. Like libsvm, the solver stops at max(10^7, 100 n) iterations
with a warning.
"""

from __future__ import annotations

import math
import warnings
import numpy as np
import torch

from caduceus_tpu_torch import resolve_device

TAU = 1e-12
CHECK_EVERY = 32     # iterations between the host's reads of the stop
GRAM_BUDGET_BYTES = 2 << 30   # the whole Gram matrix up to n = 16,384


def _as_tensor(X, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(X) if not torch.is_tensor(X) else X,
                           dtype=torch.float64, device=device)


class StandardScaler:
    """Zero mean, unit population variance per feature."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def fit(self, X) -> "StandardScaler":
        X = _as_tensor(X, self.device)
        n = X.shape[0]
        self.mean_ = X.mean(0)
        self.var_ = ((X - self.mean_) ** 2).mean(0)
        # scikit-learn's `_is_constant_feature`: a variance within the
        # rounding bound of its two-pass computation is that of a constant
        eps = torch.finfo(torch.float64).eps
        constant = self.var_ <= (n * eps * self.var_
                                 + (n * self.mean_ * eps) ** 2)
        self.scale_ = torch.where(constant, torch.ones_like(self.var_),
                                  self.var_.sqrt())
        return self

    def transform(self, X) -> torch.Tensor:
        return (_as_tensor(X, self.device) - self.mean_) / self.scale_


class SVC:
    """Binary C-SVC with the RBF kernel (libsvm's dual, solved by SMO)."""

    def __init__(self, C: float = 1.0, tol: float = 1e-3, device="cuda"):
        self.C, self.tol = float(C), float(tol)
        self.device = resolve_device(device)

    def _rbf_(self, k, sq_rows, sq):
        """exp(-gamma |a - b|^2) in place, from k = A @ X.t()."""
        return (k.mul_(-2.0).add_(sq_rows[:, None]).add_(sq[None, :])
                .clamp_(min=0.0).mul_(-self.gamma_).exp_())

    def _rows(self, X, sq, idx):
        """Kernel rows K(X[idx], X) (the diagonal exactly 1)."""
        k = self._rbf_(X[idx] @ X.t(), sq[idx], sq)
        return k.scatter_(1, idx[:, None], 1.0)

    def fit(self, X, y) -> "SVC":
        X = _as_tensor(X, self.device)
        y = np.asarray(y).ravel()
        self.classes_ = np.unique(y)
        if len(self.classes_) != 2:
            raise ValueError(f"a binary SVC needs two classes, got "
                             f"{self.classes_.tolist()}")
        n, d = X.shape
        var = X.var(unbiased=False).item()
        self.gamma_ = 1.0 / (d * var) if var != 0 else 1.0
        dev, C = self.device, self.C
        ys = torch.as_tensor(np.where(y == self.classes_[1], 1.0, -1.0),
                             dtype=torch.float64, device=dev)
        sq = (X * X).sum(1)
        gram = None
        if 8 * n * n <= GRAM_BUDGET_BYTES:
            gram = torch.mm(X, X.t(), out=torch.empty(
                n, n, dtype=torch.float64, device=dev))
            self._rbf_(gram, sq, sq).fill_diagonal_(1.0)

        def rows(idx):
            return gram.index_select(0, idx) if gram is not None else \
                self._rows(X, sq, idx)

        alpha = torch.zeros(n, dtype=torch.float64, device=dev)
        G = torch.full((n,), -1.0, dtype=torch.float64, device=dev)
        pos = ys > 0
        inf = torch.tensor(math.inf, dtype=torch.float64, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)

        def step():
            up = torch.where(pos, alpha < C, alpha > 0)
            low = torch.where(pos, alpha > 0, alpha < C)
            v = -ys * G
            v_up = torch.where(up, v, -inf)
            i = v_up.argmax().view(1)
            gmax = v_up.gather(0, i)
            gmin = torch.where(low, v, inf).min().view(1)
            k_i = rows(i)[0]
            # second order: for j in I_low with v_j < gmax, the decrease
            # (gmax - v_j)^2 / (K_ii + K_jj - 2 K_ij)
            b = gmax - v
            quad = (2.0 - 2.0 * k_i).clamp(min=0.0)
            quad = torch.where(quad > 0, quad, torch.full_like(quad, TAU))
            obj = torch.where(low & (b > 0), -(b * b) / quad, inf)
            j = obj.argmin().view(1)
            active = ((gmax - gmin) >= self.tol) & (obj.gather(0, j) < inf)
            k_j = rows(j)[0]
            # the pair moves along a_i += y_i t, a_j -= y_j t (y'a stays
            # 0), t clipped to the box; a bound reached is set exactly
            a_i, a_j = alpha.gather(0, i), alpha.gather(0, j)
            y_i, y_j = ys.gather(0, i), ys.gather(0, j)
            t = b.gather(0, j) / quad.gather(0, j)
            lim_i = torch.where(y_i > 0, C - a_i, a_i)
            lim_j = torch.where(y_j > 0, a_j, C - a_j)
            t = torch.minimum(torch.minimum(t, lim_i), lim_j)
            new_i = torch.where(t >= lim_i, torch.where(y_i > 0, C, 0.0),
                                a_i + y_i * t)
            new_j = torch.where(t >= lim_j, torch.where(y_j > 0, 0.0, C),
                                a_j - y_j * t)
            new_i = torch.where(active, new_i, a_i)
            new_j = torch.where(active, new_j, a_j)
            G.add_(ys * ((y_i * (new_i - a_i)) * k_i
                         + (y_j * (new_j - a_j)) * k_j))
            alpha.scatter_(0, torch.cat([i, j]), torch.cat([new_i, new_j]))
            done.copy_(~active[0])

        def steps():
            for _ in range(CHECK_EVERY):
                step()

        max_iter = max(10_000_000, 100 * n)   # libsvm's
        it = 0
        if dev.type == "cuda":
            # three iterations on a side stream (the allocator's blocks),
            # then `CHECK_EVERY` of them captured and replayed
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(3):
                    step()
            torch.cuda.current_stream(dev).wait_stream(side)
            it = 3
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                steps()
            steps = graph.replay
        while it < max_iter and not bool(done):
            steps()
            it += CHECK_EVERY
        if not bool(done):
            warnings.warn(f"SVC: stopped at max_iter={max_iter} before the "
                          f"gap reached tol={self.tol}")
        self.n_iter_ = it
        self._finish(X, ys, alpha, G)
        return self

    def _finish(self, X, ys, alpha, G):
        """libsvm's rho and the support vectors."""
        C = self.C
        yG = ys * G
        at_up, at_low = alpha >= C, alpha <= 0
        free = ~(at_up | at_low)
        if bool(free.any()):
            rho = yG[free].mean().item()
        else:
            pos = ys > 0
            # upper bounds of rho: a_i = C with y = -1, a_i = 0 with y = +1
            ub = yG[(at_up & ~pos) | (at_low & pos)]
            lb = yG[(at_up & pos) | (at_low & ~pos)]
            rho = ((ub.min().item() if ub.numel() else math.inf)
                   + (lb.max().item() if lb.numel() else -math.inf)) / 2
        self.rho_ = rho
        self.intercept_ = -rho
        self.alpha_ = alpha
        self.y_ = ys
        sv = alpha > 0
        self.support_ = sv.nonzero()[:, 0]
        self.support_vectors_ = X[sv]
        self.dual_coef_ = (alpha * ys)[sv]
        self._sv_sq = (self.support_vectors_ ** 2).sum(1)

    def decision_function(self, X, block: int = 4096) -> np.ndarray:
        """sum_i a_i y_i K(x_i, x) - rho for each row of ``X``."""
        X = _as_tensor(X, self.device)
        out = []
        for s in range(0, X.shape[0], block):
            x = X[s:s + block]
            k = self._rbf_(x @ self.support_vectors_.t(), (x * x).sum(1),
                           self._sv_sq)
            out.append(k @ self.dual_coef_ - self.rho_)
        if not out:
            return np.zeros(0)
        return torch.cat(out).cpu().numpy()
