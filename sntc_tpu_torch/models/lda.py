"""LDA — latent Dirichlet allocation by online variational Bayes.

Counterpart of ``sntc_tpu/models/lda.py`` (Spark's ``LDA`` with its
online optimizer, Hoffman, Blei & Bach 2010): ``k``, ``maxIter`` (one
minibatch an iteration), ``docConcentration`` α (auto → 1/k),
``topicConcentration`` η (auto → 1/k), ``learningOffset`` τ₀ (1024),
``learningDecay`` κ (0.51), ``subsamplingRate`` (0.05), ``seed``;
``optimizer="em"`` runs full-corpus batch VB-EM with Spark's EM defaults
(α → 50/k + 1, η → 1.1; every iteration E-steps ALL documents and sets
λ = η + stat).  The model has ``topicsMatrix``, ``describeTopics``,
``transform`` → ``topicDistribution``, ``logLikelihood`` and
``logPerplexity`` (the variational bound, token-normalised).

The E-step (:func:`e_step`) runs on the estimator's device in float32:
γ updates over the whole minibatch at once (two ``[b, V]×[V, k]``
products an update) until the mean |Δγ| over the documents reaches
``_MEAN_CHANGE_TOL``, the host reading that mean once an update; its
output is the ``[k, V]`` sufficient statistic.  It is a pure function of
its initial γ₀: the JAX package draws γ₀ with ``jax.random.gamma`` keyed
by each document's place in the batch, which numpy cannot reproduce, so
the port draws it with numpy from the estimator's seed, the iteration
and the document's place (:func:`gamma0`) — the card and the CPU see the
same γ₀.  λ's M-step runs on the host in float64 with the minibatch
draws of the JAX package (the same numpy ``rng``, the same calls).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import gammaln, psi

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.ops.lbfgs import full_f32

_MEAN_CHANGE_TOL = 1e-3
_MAX_E_ITERS = 100
_INFER_STREAM = 0  # γ₀ stream of transform / the bound
_FIT_STREAM = 1  # γ₀ streams of the fit, one an iteration


def gamma0(seed: int, stream: tuple, b: int, k: int) -> np.ndarray:
    """``[b, k]`` float32 initial γ: Gamma(100, 1/100) draws from a numpy
    generator seeded by ``(seed, *stream)``, row ``i`` the batch's
    ``i``-th document."""
    rng = np.random.default_rng((int(seed),) + tuple(stream))
    return rng.gamma(100.0, 1.0 / 100.0, size=(b, k)).astype(np.float32)


def _dirichlet_expectation(x: torch.Tensor) -> torch.Tensor:
    """E[log θ] under Dirichlet(x), rowwise."""
    return torch.special.digamma(x) - torch.special.digamma(
        x.sum(dim=-1, keepdim=True))


def e_step(counts: torch.Tensor, exp_elog_beta: torch.Tensor, alpha: float,
           gamma: torch.Tensor, max_iters: int = _MAX_E_ITERS):
    """The minibatch E-step from ``gamma`` (γ₀ ``[b, k]``) over the
    document counts ``[b, V]``, all on their device in float32.  Returns
    ``(γ [b, k], stat [k, V], updates, host_reads)``: the statistic is
    ``expElogθᵀ (counts / φnorm) ∘ expElogβ``."""
    n_docs = max(counts.shape[0], 1)
    it, reads = 0, 0
    with full_f32():
        while it < max_iters:
            exp_elog_theta = torch.exp(_dirichlet_expectation(gamma))
            # φnorm[d, w] = Σ_k expElogθ[d,k] expElogβ[k,w]; the 1e-100
            # is added in float32, where it is 0, as in the JAX package
            phinorm = exp_elog_theta @ exp_elog_beta + 1e-100
            new_gamma = alpha + exp_elog_theta * (
                (counts / phinorm) @ exp_elog_beta.t())
            change = (new_gamma - gamma).abs().mean(dim=1).sum() / n_docs
            gamma, it = new_gamma, it + 1
            reads += 1
            if not float(change) > _MEAN_CHANGE_TOL:
                break
        exp_elog_theta = torch.exp(_dirichlet_expectation(gamma))
        phinorm = exp_elog_theta @ exp_elog_beta + 1e-100
        stat = (exp_elog_theta.t() @ (counts / phinorm)) * exp_elog_beta
    return gamma, stat, it, reads


def _run_e_step(counts: torch.Tensor, elog_beta: np.ndarray, alpha: float,
                g0: np.ndarray):
    """One E-step on ``counts``' device from host ``exp(elog_beta)`` and
    γ₀; returns (γ, stat) as host arrays and the host reads."""
    dev = counts.device
    eeb = torch.from_numpy(np.exp(elog_beta).astype(np.float32)).to(dev)
    gamma, stat, _, reads = e_step(
        counts, eeb, alpha, torch.from_numpy(g0).to(dev))
    return gamma.cpu().numpy(), stat.cpu().numpy(), reads + 2


class _LdaParams:
    featuresCol = Param("count-vector column", default="features")
    topicDistributionCol = Param(
        "output topic-mixture column", default="topicDistribution"
    )
    k = Param("number of topics", default=10, validator=validators.gt(1))
    maxIter = Param(
        "iterations (online: one minibatch each; em: one full-corpus "
        "E+M step each)", default=20, validator=validators.gt(0),
    )
    docConcentration = Param(
        "α (None = auto: 1/k online, (50/k)+1 em — Spark per-optimizer "
        "defaults)", default=None,
        validator=lambda v: v is None or v > 0,
    )
    topicConcentration = Param(
        "η (None = auto: 1/k online, 1.1 em — Spark per-optimizer "
        "defaults)", default=None,
        validator=lambda v: v is None or v > 0,
    )
    learningOffset = Param("τ₀ downweights early iterations", default=1024.0,
                           validator=validators.gt(0))
    learningDecay = Param("κ ∈ (0.5, 1]", default=0.51,
                          validator=validators.gt(0.5))
    subsamplingRate = Param(
        "minibatch fraction per iteration, in (0, 1]", default=0.05,
        validator=lambda v: 0.0 < v <= 1.0,
    )
    optimizer = Param(
        "online (minibatch VB) | em (full-corpus batch VB-EM)",
        default="online", validator=validators.one_of("online", "em"),
    )
    seed = Param("random seed", default=0)


def _elog_beta(lam: np.ndarray) -> np.ndarray:
    return psi(lam) - psi(lam.sum(axis=1, keepdims=True))


class LDA(_LdaParams, Estimator):
    """Fits on ``device`` (default ``cuda``); the model infers there."""

    def __init__(self, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)

    def _fit(self, frame: Frame) -> "LDAModel":
        X = frame[self.getFeaturesCol()]
        if X.ndim != 2:
            raise ValueError(
                "featuresCol must be a count-vector column "
                "(CountVectorizer output)"
            )
        X = np.asarray(to_host(X), np.float32)
        if np.any(X < 0):
            raise ValueError("LDA requires non-negative counts")
        n_docs, v = X.shape
        k = int(self.getK())
        em = self.getOptimizer() == "em"
        dc = self.getDocConcentration()
        tc = self.getTopicConcentration()
        # Spark's per-optimizer auto defaults
        alpha = float(dc) if dc is not None else (
            (50.0 / k) + 1.0 if em else 1.0 / k
        )
        eta = float(tc) if tc is not None else (1.1 if em else 1.0 / k)
        tau0 = float(self.getLearningOffset())
        kappa = float(self.getLearningDecay())
        frac = float(self.getSubsamplingRate())
        batch = max(1, int(round(frac * n_docs)))
        seed = int(self.getSeed())
        rng = np.random.default_rng(self.getSeed())
        Xd = torch.from_numpy(np.ascontiguousarray(X)).to(self.device)
        reads = 0

        lam = rng.gamma(100.0, 1.0 / 100.0, size=(k, v)).astype(np.float64)
        for t in range(int(self.getMaxIter())):
            elog_beta = _elog_beta(lam)
            if em:
                # batch VB-EM: E-step the WHOLE corpus, λ at the M-step
                # fixed point — no minibatch scaling, no decay
                _, stat, r = _run_e_step(
                    Xd, elog_beta, alpha,
                    gamma0(seed, (_FIT_STREAM, t), n_docs, k))
                lam = eta + np.asarray(stat, np.float64)
            else:
                idx = rng.choice(n_docs, size=batch, replace=False)
                rows = torch.from_numpy(idx).to(self.device)
                _, stat, r = _run_e_step(
                    Xd.index_select(0, rows), elog_beta, alpha,
                    gamma0(seed, (_FIT_STREAM, t), batch, k))
                rho = (tau0 + t) ** (-kappa)
                lam_hat = (
                    eta + (n_docs / batch) * np.asarray(stat, np.float64)
                )
                lam = (1.0 - rho) * lam + rho * lam_hat
            reads += r

        model = LDAModel(lam=lam, alpha=alpha, eta=eta, numDocs=n_docs,
                         device=self.device)
        model.setParams(**self.paramValues())
        model.fit_stats = {"iterations": int(self.getMaxIter()),
                           "host_reads": reads}
        return model


class LDAModel(_LdaParams, Model):
    def __init__(self, lam, alpha: float, eta: float, numDocs: int = 0,
                 device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.lam = np.asarray(lam, np.float64)  # [k, V] variational λ
        self.alpha = float(alpha)
        self.eta = float(eta)
        self.numDocs = int(numDocs)
        self.device = resolve_device(device)
        self.fit_stats = None

    @property
    def vocabSize(self) -> int:
        return self.lam.shape[1]

    def topicsMatrix(self) -> np.ndarray:
        """[V, k] expected word probability per topic (Spark layout)."""
        return (self.lam / self.lam.sum(axis=1, keepdims=True)).T

    def describeTopics(self, maxTermsPerTopic: int = 10) -> Frame:
        probs = self.lam / self.lam.sum(axis=1, keepdims=True)
        order = np.argsort(-probs, axis=1)[:, :maxTermsPerTopic]
        weights = np.take_along_axis(probs, order, axis=1)
        return Frame({
            "topic": np.arange(self.lam.shape[0], dtype=np.int64),
            "termIndices": order.astype(np.int64),
            "termWeights": weights,
        })

    def _infer_gamma(self, X: np.ndarray) -> np.ndarray:
        counts = torch.from_numpy(
            np.ascontiguousarray(X, np.float32)).to(self.device)
        gamma, _, _ = _run_e_step(
            counts, _elog_beta(self.lam), self.alpha,
            gamma0(int(self.getSeed()), (_INFER_STREAM,), X.shape[0],
                   self.lam.shape[0]))
        return np.asarray(gamma, np.float64)

    def transform(self, frame: Frame) -> Frame:
        X = np.asarray(to_host(frame[self.getFeaturesCol()]), np.float32)
        gamma = self._infer_gamma(X)
        theta = gamma / gamma.sum(axis=1, keepdims=True)
        return frame.with_column(self.getTopicDistributionCol(), theta)

    def _bound(self, X: np.ndarray) -> float:
        """Variational ELBO of ``X`` (Hoffman eq. 3; mllib's
        ``logLikelihoodBound``) — behind ``logLikelihood`` and
        ``logPerplexity``; host float64 from the inferred γ."""
        gamma = self._infer_gamma(X)
        k, v = self.lam.shape
        elog_theta = psi(gamma) - psi(gamma.sum(axis=1, keepdims=True))
        elog_beta = _elog_beta(self.lam)
        # E[log p(docs | θ, β)]: the token-level softmax bound
        score = 0.0
        norm = np.log(
            np.exp(elog_theta) @ np.exp(elog_beta) + 1e-100
        )
        score += float((X * norm).sum())
        # E[log p(θ | α) - log q(θ | γ)]
        score += float(
            ((self.alpha - gamma) * elog_theta).sum()
            + (gammaln(gamma) - gammaln(self.alpha)).sum()
            + (gammaln(self.alpha * k) - gammaln(gamma.sum(axis=1))).sum()
        )
        # E[log p(β | η) - log q(β | λ)]
        score += float(
            ((self.eta - self.lam) * elog_beta).sum()
            + (gammaln(self.lam) - gammaln(self.eta)).sum()
            + (gammaln(self.eta * v) - gammaln(self.lam.sum(axis=1))).sum()
        )
        return score

    def logLikelihood(self, frame: Frame) -> float:
        return self._bound(
            np.asarray(to_host(frame[self.getFeaturesCol()]), np.float32)
        )

    def logPerplexity(self, frame: Frame) -> float:
        X = np.asarray(to_host(frame[self.getFeaturesCol()]), np.float32)
        tokens = float(X.sum())
        return -self._bound(X) / max(tokens, 1.0)

    def _save_extra(self):
        return (
            {"alpha": self.alpha, "eta": self.eta, "numDocs": self.numDocs},
            {"lam": self.lam},
        )

    @classmethod
    def _load_from(cls, params, extra, arrays, device="cuda"):
        m = cls(
            lam=arrays["lam"], alpha=float(extra["alpha"]),
            eta=float(extra["eta"]), numDocs=int(extra["numDocs"]),
            device=device,
        )
        m.setParams(**params)
        return m
