"""Faults planted under the timed path, for the tests that see a run
come out not correct.  Each is a ``main_fun`` the trainer can import:
it breaks the program in the trainer's process, then calls the real
one."""

from __future__ import annotations

from portbench import trainer


def _unchanged_steps():
    """Every optimizer step returns the params as they were."""
    import torch

    for cls in (torch.optim.Adam, torch.optim.SGD):
        real = cls.step

        def step(self, closure=None, _real=real):
            leaves = [p for g in self.param_groups for p in g["params"]]
            saved = [p.detach().clone() for p in leaves]
            out = _real(self, closure)
            with torch.no_grad():
                for p, s in zip(leaves, saved):
                    p.copy_(s)
            return out

        cls.step = step


def _half_batch_lm():
    """The loss over the first half of each batch."""
    from tensorflowonspark_tpu_torch.models import transformer as T

    real = T.loss_fn
    T.loss_fn = lambda params, tokens, cfg, **kw: real(
        params, tokens[:tokens.shape[0] // 2], cfg, **kw)


def _half_batch_resnet():
    from tensorflowonspark_tpu_torch.models import layers as L

    real = L.softmax_cross_entropy
    L.softmax_cross_entropy = lambda logits, labels, num_classes=None: real(
        logits[:logits.shape[0] // 2], labels[:labels.shape[0] // 2])


LM = "tensorflowonspark_tpu_torch.examples.transformer_spark:main_fun"
RESNET = ("tensorflowonspark_tpu_torch.examples.resnet_imagenet_spark:"
          "main_fun")


def unchanged_lm(args, ctx):
    _unchanged_steps()
    trainer.resolve(LM)(args, ctx)


def unchanged_resnet(args, ctx):
    _unchanged_steps()
    trainer.resolve(RESNET)(args, ctx)


def half_lm(args, ctx):
    _half_batch_lm()
    trainer.resolve(LM)(args, ctx)


def half_resnet(args, ctx):
    _half_batch_resnet()
    trainer.resolve(RESNET)(args, ctx)
