"""Adam and AdamW (counterpart of ``paddle_tpu/optimizer/optimizers.py``).

Each update follows the reference's arithmetic in fp32: moments in
fp32, the optional fp32 master weight (``multi_precision``) copied from
the parameter's own values, bias corrections 1 - beta^step."""

from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer, f32

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    """Adam; ``weight_decay`` adds coeff * param to the gradient (L2)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad
        self._multi_precision = multi_precision

    def _ensure_state(self):
        self._init_slot("moment1", like_master=True)
        self._init_slot("moment2", like_master=True)
        if self._amsgrad:
            self._init_slot("moment2_max", like_master=True)
        if self._multi_precision \
                and "master_weight" not in self._accumulators:
            # from the parameter's own (bf16-rounded) values, as the
            # reference does
            self._accumulators["master_weight"] = [
                p.detach().float().clone() for p in self._parameter_list]

    def _decayed_grad(self, i, pw, g32, coeff):
        return g32 if coeff is None else g32 + coeff * pw

    def _decayed_param(self, i, pw, lr, coeff):
        return pw

    def _update(self, i, p, g, lr, step, coeff):
        st = self._accumulators
        b1, b2 = self._beta1, self._beta2
        bc1 = f32(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = f32(np.float32(1) - np.float32(b2) ** np.float32(step))
        master = st["master_weight"][i] if "master_weight" in st else None
        pw = master if master is not None else p.float()
        g32 = self._decayed_grad(i, pw, g.float(), coeff)
        m = st["moment1"][i].mul_(b1).add_((1 - b1) * g32)
        v = st["moment2"][i].mul_(b2).add_((1 - b2) * g32 * g32)
        if self._amsgrad:
            v = torch.maximum(st["moment2_max"][i], v,
                              out=st["moment2_max"][i])
        denom = (v / bc2).sqrt_().add_(self._epsilon)
        new = self._decayed_param(i, pw, lr, coeff) \
            - (lr * (m / bc1)).div_(denom)
        if master is not None:
            master.copy_(new)
        p.copy_(new)


class AdamW(Adam):
    """Decoupled weight decay, the reference's: before the Adam step the
    (master) parameter is multiplied by 1 - lr * coeff, for every
    parameter whose name ``apply_decay_param_fun`` accepts (all when it
    is None)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode,
                         multi_precision, amsgrad=amsgrad, name=name)
        f = apply_decay_param_fun
        self._decay_mask = [True if f is None else bool(f(n))
                            for n in self._names]

    def _decayed_grad(self, i, pw, g32, coeff):
        return g32

    def _decayed_param(self, i, pw, lr, coeff):
        if coeff is None or not self._decay_mask[i]:
            return pw
        return pw * f32(np.float32(1) - np.float32(lr) * np.float32(coeff))
