"""GLM objective: value / gradient / Hessian-vector contracts (port of
``photon_ml_tpu/ops/glm.py``).

Objective = Σ_i weight_i·l(margin_i, y_i) + 0.5·λ₂·Σ_j mask_j·prec_j·(w_j − μ_j)²
(μ = 0, prec = 1 for plain L2). Sums, not means, as in the reference.

With ``fused`` set on a dense batch, ``value_and_grad`` and ``hvp`` run the
one-pass kernels K1 / K2 (``ops/fused.py``): on a CUDA batch they launch
the CUDA kernels or raise; on a CPU batch they run the kernels' plain
versions. Every other contract, and the unfused branch, is plain torch with
``torch.matmul`` for X@u and Xᵀr (the reference leaves those to XLA); on a
``TiledSparseBatch`` the batch's ``matvec`` / ``rmatvec`` / ``rmatvec_sq``
run the sparse kernel K3 (``ops/sparse_tiled.py``).

Each contract is the data's partial sums (the ``*_partials`` methods)
finished by the normalization and the regularizer (the ``_finish_*``
methods). The reference's cross-device ``psum`` (``axis_name``) sits
between the two; here ``parallel/distributed.py``'s ``ShardedGLMObjective``
sums the shards' partials and finishes once.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from photon_ml_tpu_torch._device import check_device
from photon_ml_tpu_torch.normalization import NormalizationContext, no_normalization
from photon_ml_tpu_torch.ops.batch import Batch, DenseBatch, SparseBatch, TiledSparseBatch
from photon_ml_tpu_torch.ops.fused import fused_hvp, fused_value_grad, supports_fused
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.types import VarianceComputationType

Tensor = torch.Tensor

# The reference's message for the contracts that need the full Hessian
# (Newton's solve, FULL variances).
FULL_HESSIAN_NEEDS_DENSE = "full Hessian requires a DenseBatch; use hessian_diag or hvp"


def reg_delta(w: Tensor, prior_mean, prior_precision) -> Tensor:
    """prec·(w − μ): the regularizer's gradient direction (w for plain L2)."""
    if prior_mean is None:
        return w
    prec = torch.ones_like(w) if prior_precision is None else prior_precision
    return prec * (w - prior_mean)


def reg_curvature(like: Tensor, prior_mean, prior_precision) -> Tensor:
    """The regularizer's diagonal curvature scale (prec, or ones)."""
    if prior_mean is None or prior_precision is None:
        return torch.ones_like(like)
    return prior_precision


def reg_term(w: Tensor, l2_weight, reg_mask, prior_mean, prior_precision) -> Tensor:
    """0.5·λ₂·Σ maskⱼ·precⱼ·(wⱼ−μⱼ)²."""
    delta = w if prior_mean is None else w - prior_mean
    prec = reg_curvature(w, prior_mean, prior_precision)
    return 0.5 * l2_weight * torch.sum(reg_mask * prec * delta * delta)


@dataclass(frozen=True)
class GLMObjective:
    """Value/gradient/Hv contracts consumed by the optimizers.

      batch     — the training data.
      norm      — normalization applied inside evaluation (never to data).
      l2_weight — 0-d tensor λ₂.
      reg_mask  — (d,) 0/1 mask of regularized coordinates (intercept → 0).
      loss      — pointwise loss.
      fused     — use the one-pass kernels for value_and_grad / hvp.
      offsets_zero / weights_one — constant-0 offsets / constant-1 weights:
                  the fused kernels then read neither array.
      prior_mean / prior_precision — optional (d,) Gaussian prior (MAP).
    """

    batch: Batch
    norm: NormalizationContext
    l2_weight: Tensor
    reg_mask: Tensor
    loss: PointwiseLoss
    fused: bool = False
    offsets_zero: bool = False
    weights_one: bool = False
    prior_mean: Tensor | None = None
    prior_precision: Tensor | None = None

    def _weighted(self, x: Tensor) -> Tensor:
        """weights * x with zero-weight rows forced to exactly 0 (a select:
        0 * inf would be NaN, e.g. an overflowed Poisson loss on padding)."""
        w = self.batch.weights
        return torch.where(w != 0.0, w * x, torch.zeros_like(x))

    # -- margins --------------------------------------------------------------
    def margins(self, w: Tensor) -> Tensor:
        u, c = self.norm.to_effective(w)
        return self.batch.matvec(u) - c + self.batch.offsets

    # -- regularizer -------------------------------------------------------------
    def _reg_delta(self, w: Tensor) -> Tensor:
        return reg_delta(w, self.prior_mean, self.prior_precision)

    def _reg_curvature(self, like: Tensor) -> Tensor:
        return reg_curvature(like, self.prior_mean, self.prior_precision)

    def _l2_term(self, w: Tensor) -> Tensor:
        return reg_term(w, self.l2_weight, self.reg_mask, self.prior_mean, self.prior_precision)

    @property
    def one_pass_value_grad(self) -> bool:
        """Line-search policy hint: evaluate value_and_grad at every trial
        point. True when the fused kernel makes value_and_grad cost one X
        read anyway, or on a ``TiledSparseBatch``, where a trial of margins
        and gradient (two sparse passes) beats a margins-only trial plus a
        margins-and-gradient pass at acceptance (three)."""
        return self.fused or isinstance(self.batch, TiledSparseBatch)

    def value_partial(self, w: Tensor) -> Tensor:
        """Σ weight·loss over the batch's rows (no regularizer)."""
        m = self.margins(w)
        return torch.sum(self._weighted(self.loss.value(m, self.batch.labels)))

    def value(self, w: Tensor) -> Tensor:
        return self.value_partial(w) + self._l2_term(w)

    # -- margin-state API ------------------------------------------------------
    def direction_margins(self, p: Tensor) -> Tensor:
        """d margins / d t along direction p (no offset term)."""
        u_p, c_p = self.norm.to_effective(p)
        return self.batch.matvec(u_p) - c_p

    def _finish_grad(self, val, g_raw, r_sum, w):
        g = self.norm.grad_to_model_space(g_raw, r_sum) + (
            self.l2_weight * self.reg_mask * self._reg_delta(w)
        )
        return val + self._l2_term(w), g

    def value_and_grad_partials_from_margins(self, m: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """(Σ weight·loss, Xᵀr, Σr) with r = weight·l'(m, y)."""
        lv = self.loss.value(m, self.batch.labels)
        r = self._weighted(self.loss.d1(m, self.batch.labels))
        return torch.sum(self._weighted(lv)), self.batch.rmatvec(r), torch.sum(r)

    def value_and_grad_from_margins(self, m: Tensor, w: Tensor) -> tuple[Tensor, Tensor]:
        return self._finish_grad(*self.value_and_grad_partials_from_margins(m), w)

    def hessian_partial_from_margins(self, m: Tensor) -> Tensor:
        """Zᵀ diag(weight·l'') Z over the batch's rows (Z the normalized
        design; dense batches only)."""
        if not isinstance(self.batch, DenseBatch):
            raise NotImplementedError(FULL_HESSIAN_NEEDS_DENSE)
        d2 = self._weighted(self.loss.d2(m, self.batch.labels))
        Z = (self.batch.X.float() - self.norm.shifts) * self.norm.factors
        return Z.T @ (d2[:, None] * Z)

    def _finish_hessian(self, h: Tensor) -> Tensor:
        return h + torch.diag(
            self.l2_weight * self.reg_mask * self._reg_curvature(self.reg_mask)
        )

    def hessian_from_margins(self, m: Tensor, w: Tensor) -> Tensor:
        return self._finish_hessian(self.hessian_partial_from_margins(m))

    def ray_values_from_margins(
        self, m: Tensor, dm: Tensor, w: Tensor, p: Tensor, ts: Tensor
    ) -> Tensor:
        """Objective at w + t·p for every t in ``ts`` from stored margins —
        no matvec at all."""
        return self.ray_partials_from_margins(m, dm, ts) + self._reg_ray(w, p, ts)

    def ray_partials_from_margins(self, m: Tensor, dm: Tensor, ts: Tensor) -> Tensor:
        """(len(ts),): Σ weight·loss at margins m + t·dm for each t."""
        y = self.batch.labels
        return torch.stack(
            [torch.sum(self._weighted(self.loss.value(m + t * dm, y))) for t in ts]
        )

    def _reg_ray(self, w: Tensor, p: Tensor, ts: Tensor) -> Tensor:
        delta = w if self.prior_mean is None else w - self.prior_mean
        prec = self._reg_curvature(w)
        q0 = torch.sum(self.reg_mask * prec * delta * delta)
        q1 = torch.sum(self.reg_mask * prec * delta * p)
        q2 = torch.sum(self.reg_mask * prec * p * p)
        return 0.5 * self.l2_weight * (q0 + 2.0 * ts * q1 + ts * ts * q2)

    def ray_values(self, w: Tensor, p: Tensor, ts: Tensor) -> Tensor:
        """Objective at ``w + t·p`` for every t in ``ts``; the data is read
        for two matvecs regardless of len(ts) (margins are affine in w)."""
        return self.ray_values_from_margins(
            self.margins(w), self.direction_margins(p), w, p, ts
        )

    # -- fused-capable contracts ----------------------------------------------
    def _aux(self):
        b = self.batch
        return (
            None if self.offsets_zero else b.offsets,
            None if self.weights_one else b.weights,
        )

    def value_and_grad_partials(self, w: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """(Σ weight·loss, Xᵀr, Σr) at w: one K1 launch when fused."""
        if not (self.fused and isinstance(self.batch, DenseBatch)):
            return self.value_and_grad_partials_from_margins(self.margins(w))
        u, c = self.norm.to_effective(w)
        offsets, weights = self._aux()
        return fused_value_grad(
            self.batch.X, self.batch.labels, offsets, weights, u, c, loss=self.loss
        )

    def value_and_grad(self, w: Tensor) -> tuple[Tensor, Tensor]:
        return self._finish_grad(*self.value_and_grad_partials(w), w)

    def grad(self, w: Tensor) -> Tensor:
        return self.value_and_grad(w)[1]

    def hvp_partials(self, w: Tensor, v: Tensor) -> tuple[Tensor, Tensor]:
        """(Xᵀq, Σq) with q = weight·l''·(X·v_eff − cv): one K2 launch when
        fused."""
        v_eff = self.norm.factors * v
        cv = torch.dot(self.norm.shifts, v_eff)
        if self.fused and isinstance(self.batch, DenseBatch):
            u, c = self.norm.to_effective(w)
            offsets, weights = self._aux()
            return fused_hvp(
                self.batch.X, self.batch.labels, offsets, weights, u, v_eff, c, cv,
                loss=self.loss,
            )
        m = self.margins(w)
        d2 = self._weighted(self.loss.d2(m, self.batch.labels))
        q = d2 * (self.batch.matvec(v_eff) - cv)
        return self.batch.rmatvec(q), torch.sum(q)

    def _finish_hvp(self, hv_raw: Tensor, q_sum: Tensor, v: Tensor) -> Tensor:
        hv = self.norm.grad_to_model_space(hv_raw, q_sum)
        return hv + self.l2_weight * self.reg_mask * self._reg_curvature(v) * v

    def hvp(self, w: Tensor, v: Tensor) -> Tensor:
        """Gauss-Newton H·v = AᵀDA·v + λ₂·v (A the normalized design, D =
        diag(weight·d2)); TRON's CG inner step."""
        return self._finish_hvp(*self.hvp_partials(w, v), v)

    def hessian_diag_partials(self, w: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """(Σ d2 x², Σ d2 x, Σ d2) with d2 = weight·l''."""
        m = self.margins(w)
        d2 = self._weighted(self.loss.d2(m, self.batch.labels))
        return self.batch.rmatvec_sq(d2), self.batch.rmatvec(d2), torch.sum(d2)

    def _finish_hessian_diag(self, sq: Tensor, lin: Tensor, tot: Tensor) -> Tensor:
        f, s = self.norm.factors, self.norm.shifts
        diag = f * f * (sq - 2.0 * s * lin + s * s * tot)
        return diag + self.l2_weight * self.reg_mask * self._reg_curvature(diag)

    def hessian_diag(self, w: Tensor) -> Tensor:
        """diag(H) = f² [Σ d2 x² − 2 s Σ d2 x + s² Σ d2] + λ₂·mask."""
        return self._finish_hessian_diag(*self.hessian_diag_partials(w))

    def hessian(self, w: Tensor) -> Tensor:
        """Full (d, d) Hessian (dense batches only)."""
        return self.hessian_from_margins(self.margins(w), w)


@dataclass(frozen=True)
class GaussianPrior:
    """Informative Gaussian prior for incremental training (MAP update):
    pull toward ``means`` with per-coordinate strength 1/variance."""

    means: Tensor
    variances: Tensor | None = None
    min_variance: float = 1e-6

    @property
    def precisions(self) -> Tensor | None:
        """1/variance; non-positive variances are uninformative (precision
        1), as the reference gives missing prior features variance 1."""
        if self.variances is None:
            return None
        v = self.variances.float()
        return torch.where(v > 0.0, 1.0 / torch.clamp_min(v, self.min_variance), torch.ones_like(v))

    @classmethod
    def from_coefficients(cls, means, variances, norm=None) -> "GaussianPrior":
        """The prior in the solver's (normalized) space from
        original-space coefficients: means through the normalization,
        variances through var_norm = var_out / f²."""
        mu = torch.as_tensor(means, dtype=torch.float32)
        if norm is not None:
            mu = norm.model_from_original_space(mu)
        var = None
        if variances is not None:
            var = torch.as_tensor(variances, dtype=torch.float32)
            if norm is not None:
                var = var / (norm.factors**2)
        return cls(means=mu, variances=var)


def reg_mask(d: int, intercept_index: int | None, device) -> Tensor:
    """(d,) float32: 1 on every regularized coordinate, 0 on the intercept;
    made on the device by kernels alone (a captured visit builds it)."""
    mask = torch.ones(d, dtype=torch.float32, device=device)
    if intercept_index is not None:
        mask.index_fill_(0, torch.full((1,), intercept_index, dtype=torch.int64, device=device), 0.0)
    return mask


def device_scalar(x: float | Tensor, device, dtype=torch.float32) -> Tensor:
    """A 0-d tensor of ``x`` on ``device``: a tensor converted where it
    lies, a Python number written by a fill on the device (never a copy
    from the host, which a captured CUDA graph cannot hold)."""
    if isinstance(x, Tensor):
        return torch.as_tensor(x, dtype=dtype, device=device)
    return torch.full((), float(x), dtype=dtype, device=device)


def compute_variances(obj, w: Tensor, variance_type: VarianceComputationType) -> Tensor | None:
    """Coefficient variances from the Hessian at the optimum: SIMPLE
    inverts its diagonal, FULL takes the diagonal of its inverse. For a
    ``LaneGLMObjective`` every lane's, (k, d)."""
    if variance_type is VarianceComputationType.NONE:
        return None
    if variance_type is VarianceComputationType.SIMPLE:
        return 1.0 / torch.clamp_min(obj.hessian_diag(w), 1e-12)
    H = obj.hessian(w)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return torch.diagonal(torch.linalg.inv(H + 1e-9 * eye), dim1=-2, dim2=-1)


def make_objective(
    batch: Batch,
    loss: PointwiseLoss,
    l2_weight: float | Tensor = 0.0,
    norm: NormalizationContext | None = None,
    intercept_index: int | None = None,
    fused: bool | None = None,
    data_hints: tuple[bool, bool] | None = None,
    prior: GaussianPrior | None = None,
    device=None,
) -> GLMObjective:
    """Objective on ``device`` (CUDA unless the caller passes another), which
    must hold ``batch``. ``intercept_index`` is excluded from L2.
    ``fused=None`` enables the kernels for dense CUDA batches of a shape
    they take (``auto_fused``); ``True``/``False`` force it (``True`` on a
    CPU batch runs the kernels' plain versions). ``data_hints`` = (offsets
    all zero, weights all one) for callers that know their data; otherwise
    the batch is scanned once (``_constant_hints``)."""
    dev = check_device(batch.device, device)
    d = batch.num_features
    norm = no_normalization(d, intercept_index, device=dev) if norm is None else norm.to(dev)
    mask = reg_mask(d, intercept_index, dev)
    if fused is None:
        fused = auto_fused(batch)
    offsets_zero = weights_one = False
    if fused:
        offsets_zero, weights_one = (
            data_hints if data_hints is not None else _constant_hints(batch)
        )
    return GLMObjective(
        batch=batch,
        norm=norm,
        l2_weight=device_scalar(l2_weight, dev),
        reg_mask=mask,
        loss=loss,
        fused=bool(fused),
        offsets_zero=offsets_zero,
        weights_one=weights_one,
        prior_mean=None if prior is None else prior.means.to(dev),
        prior_precision=None if prior is None or prior.variances is None
        else prior.precisions.to(dev),
    )


def fused_disabled() -> bool:
    """``PHOTON_DISABLE_FUSED`` veto for ``auto_fused``, strict int parse:
    unset or empty keeps fusion, ``0`` keeps it, any other int vetoes it,
    a non-int raises."""
    env = os.environ.get("PHOTON_DISABLE_FUSED")
    if env is not None and env != "":
        return int(env) != 0
    return False


def auto_fused(batch: Batch) -> bool:
    """Use the one-pass kernels? True for dense CUDA batches of a shape
    ``supports_fused`` takes, unless ``PHOTON_DISABLE_FUSED`` vetoes."""
    return (
        isinstance(batch, DenseBatch)
        and batch.X.device.type == "cuda"
        and not fused_disabled()
        and supports_fused(batch.num_rows, batch.num_features, batch.X.dtype)
    )


def _constant_hints(batch: Batch) -> tuple[bool, bool]:
    """(offsets all 0, weights all 1). The reference inspects only host
    arrays, since a device check costs it a host sync per objective; here
    the check is two reductions and two host reads per objective, against
    the many passes over X that the solve then makes without those arrays."""
    return bool(torch.all(batch.offsets == 0.0)), bool(torch.all(batch.weights == 1.0))


# ---------------------------------------------------------------------------
# lane-batched objective: k independent GLMs of one geometry
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LaneGLMObjective:
    """k GLM objectives of one (C, d) geometry evaluated together: the
    reference's ``make_objective`` under ``jax.vmap`` over an entity lane,
    with batched products in place of the vmapped matvecs.

      batch — a ``DenseBatch`` whose X is (k, C, d) float32, or a
              ``SparseBatch`` whose indices and values are (k, C, nnz):
              their products run per lane. Labels / offsets / weights are
              (k, C). Padded slots carry weight 0 (and zeroed feature
              values), so they stay inert.
      norm  — one ``NormalizationContext`` shared by every lane, or None
              for the identity (the same values as the identity context:
              x − 0 and x·1 are exact).
      l2_weight, reg_mask — as ``GLMObjective`` (the intercept unregularized).
      prior_mean / prior_precision — optional (k, d) per-lane Gaussian prior.

    Values are (k,), gradients (k, d), Hessians (k, d, d). The margin API
    (``margins``, ``direction_margins``, ``value_from_margins``,
    ``value_and_grad_from_margins``, ``hvp_from_margins``,
    ``hessian_from_margins``, ``ray_values_from_margins``) is what the lane
    solvers run on; each contract is one pair of batched products at most.
    The full Hessian, and so Newton and FULL variances, needs a dense
    batch, as in the reference."""

    batch: DenseBatch | SparseBatch
    norm: NormalizationContext | None
    l2_weight: Tensor
    reg_mask: Tensor
    loss: PointwiseLoss
    prior_mean: Tensor | None = None
    prior_precision: Tensor | None = None

    @property
    def num_lanes(self) -> int:
        return self.batch.labels.shape[0]

    @property
    def dense(self) -> bool:
        return isinstance(self.batch, DenseBatch)

    def _weighted(self, x: Tensor) -> Tensor:
        w = self.batch.weights
        return torch.where(w != 0.0, w * x, torch.zeros_like(x))

    def _effective(self, w: Tensor) -> tuple[Tensor, Tensor | None]:
        if self.norm is None:
            return w, None
        u = self.norm.factors * w
        return u, torch.sum(self.norm.shifts * u, dim=-1)

    def _design(self) -> Tensor:
        """The normalized design Z = (X − s)·f (X itself for the identity)."""
        if not self.dense:
            raise NotImplementedError(FULL_HESSIAN_NEEDS_DENSE)
        X = self.batch.X
        if self.norm is None:
            return X
        return (X - self.norm.shifts) * self.norm.factors

    def _to_model_space(self, g_raw: Tensor, r_sum: Tensor) -> Tensor:
        if self.norm is None:
            return g_raw
        return self.norm.factors * (g_raw - self.norm.shifts * r_sum.unsqueeze(-1))

    # -- regularizer ----------------------------------------------------------
    def _delta(self, w: Tensor) -> Tensor:
        return w if self.prior_mean is None else w - self.prior_mean

    def _prec(self, like: Tensor) -> Tensor:
        return reg_curvature(like, self.prior_mean, self.prior_precision)

    def _reg_value(self, w: Tensor) -> Tensor:
        delta = self._delta(w)
        return 0.5 * self.l2_weight * torch.sum(self.reg_mask * self._prec(w) * delta * delta, dim=-1)

    def _reg_grad(self, w: Tensor) -> Tensor:
        return self.l2_weight * self.reg_mask * reg_delta(w, self.prior_mean, self.prior_precision)

    # -- margin API -----------------------------------------------------------
    def margins(self, w: Tensor) -> Tensor:
        return self.direction_margins(w) + self.batch.offsets

    def direction_margins(self, p: Tensor) -> Tensor:
        u, c = self._effective(p)
        m = self.batch.matvec(u)
        return m if c is None else m - c.unsqueeze(-1)

    def value_from_margins(self, m: Tensor, w: Tensor) -> Tensor:
        """(k,): every lane's objective from its margins (no product)."""
        val = torch.sum(self._weighted(self.loss.value(m, self.batch.labels)), dim=-1)
        return val + self._reg_value(w)

    def value_and_grad_from_margins(self, m: Tensor, w: Tensor) -> tuple[Tensor, Tensor]:
        y = self.batch.labels
        val = torch.sum(self._weighted(self.loss.value(m, y)), dim=-1)
        r = self._weighted(self.loss.d1(m, y))
        g = self._to_model_space(self.batch.rmatvec(r), torch.sum(r, dim=-1))
        return val + self._reg_value(w), g + self._reg_grad(w)

    def hvp_from_margins(self, m: Tensor, v: Tensor) -> Tensor:
        """(k, d) Gauss-Newton H·v at the point whose margins are m: one
        product forward (Z·v) and one back (Zᵀq), plus the regularizer's."""
        d2 = self._weighted(self.loss.d2(m, self.batch.labels))
        q = d2 * self.direction_margins(v)
        hv = self._to_model_space(self.batch.rmatvec(q), torch.sum(q, dim=-1))
        return hv + self.l2_weight * self.reg_mask * self._prec(v) * v

    def hessian_from_margins(self, m: Tensor, w: Tensor) -> Tensor:
        """Zᵀ diag(weight·l'') Z per lane by one batched product (never a
        (k, C, d, d) temporary), plus the regularizer's diagonal."""
        Z = self._design()
        d2 = self._weighted(self.loss.d2(m, self.batch.labels))
        h = torch.bmm(Z.transpose(1, 2), d2.unsqueeze(-1) * Z)
        reg = self.l2_weight * self.reg_mask * self._prec(self.reg_mask)
        return h + torch.diag_embed(reg.expand(h.shape[:-1]))

    def ray_values_from_margins(
        self, m: Tensor, dm: Tensor, w: Tensor, p: Tensor, ts: Tensor
    ) -> Tensor:
        """(k, K): every lane's objective at w + t·p for each of the K
        steps in ``ts``, from stored margins (no matvec)."""
        y = self.batch.labels
        data = torch.stack(
            [torch.sum(self._weighted(self.loss.value(m + t * dm, y)), dim=-1) for t in ts], dim=-1
        )
        delta, prec = self._delta(w), self._prec(w)
        q0 = torch.sum(self.reg_mask * prec * delta * delta, dim=-1, keepdim=True)
        q1 = torch.sum(self.reg_mask * prec * delta * p, dim=-1, keepdim=True)
        q2 = torch.sum(self.reg_mask * prec * p * p, dim=-1, keepdim=True)
        return data + 0.5 * self.l2_weight * (q0 + 2.0 * ts * q1 + ts * ts * q2)

    # -- whole-point contracts ------------------------------------------------
    def value(self, w: Tensor) -> Tensor:
        return self.value_from_margins(self.margins(w), w)

    def value_and_grad(self, w: Tensor) -> tuple[Tensor, Tensor]:
        return self.value_and_grad_from_margins(self.margins(w), w)

    def hvp(self, w: Tensor, v: Tensor) -> Tensor:
        return self.hvp_from_margins(self.margins(w), v)

    def hessian(self, w: Tensor) -> Tensor:
        return self.hessian_from_margins(self.margins(w), w)

    def hessian_diag(self, w: Tensor) -> Tensor:
        """diag(H) = f² [Σ d2 x² − 2 s Σ d2 x + s² Σ d2] + λ₂·mask per lane."""
        d2 = self._weighted(self.loss.d2(self.margins(w), self.batch.labels))
        sq = self.batch.rmatvec_sq(d2)
        if self.norm is None:
            diag = sq
        else:
            f, s = self.norm.factors, self.norm.shifts
            lin, tot = self.batch.rmatvec(d2), torch.sum(d2, dim=-1, keepdim=True)
            diag = f * f * (sq - 2.0 * s * lin + s * s * tot)
        return diag + self.l2_weight * self.reg_mask * self._prec(diag)


def make_lane_objective(
    batch: DenseBatch | SparseBatch,
    loss: PointwiseLoss,
    l2_weight: float | Tensor = 0.0,
    norm: NormalizationContext | None = None,
    intercept_index: int | None = None,
    prior_mean: Tensor | None = None,
    prior_variances: Tensor | None = None,
) -> LaneGLMObjective:
    """A ``LaneGLMObjective`` on the batch's device; ``intercept_index`` is
    excluded from L2, and prior variances become precisions as
    ``GaussianPrior.precisions`` makes them."""
    lanes_shape = (
        isinstance(batch, DenseBatch) and batch.X.dim() == 3
        or isinstance(batch, SparseBatch) and batch.indices.dim() == 3
    )
    if not lanes_shape:
        raise ValueError(
            "lane-batched objectives take a (k, C, d) DenseBatch or a (k, C, nnz) SparseBatch"
        )
    dev = batch.device
    d = batch.num_features
    mask = reg_mask(d, intercept_index, dev)
    prec = None
    if prior_mean is not None and prior_variances is not None:
        prec = GaussianPrior(means=prior_mean, variances=prior_variances).precisions
    return LaneGLMObjective(
        batch=batch,
        norm=None if norm is None else norm.to(dev),
        l2_weight=device_scalar(l2_weight, dev),
        reg_mask=mask,
        loss=loss,
        prior_mean=prior_mean,
        prior_precision=prec,
    )


def lanes_of(obj: GLMObjective) -> LaneGLMObjective:
    """A one-lane view of a dense single-GLM objective (no copy of X)."""
    b = obj.batch
    if not isinstance(b, DenseBatch):
        raise NotImplementedError(
            "NEWTON_CHOLESKY needs the full Hessian, which takes a DenseBatch"
        )
    one = DenseBatch(
        X=b.X.float().unsqueeze(0), labels=b.labels.unsqueeze(0),
        offsets=b.offsets.unsqueeze(0), weights=b.weights.unsqueeze(0),
    )
    return LaneGLMObjective(
        batch=one, norm=obj.norm, l2_weight=obj.l2_weight, reg_mask=obj.reg_mask, loss=obj.loss,
        prior_mean=None if obj.prior_mean is None else obj.prior_mean.unsqueeze(0),
        prior_precision=None if obj.prior_precision is None else obj.prior_precision.unsqueeze(0),
    )
