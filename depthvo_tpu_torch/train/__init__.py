"""Loss graph, train step, host loop and held-out evaluation of the port
(counterpart of ``depthvo_tpu.train``).

The loop's names resolve on first use: ``train.loop`` imports the
checkpoint modules, which import ``train.state``, so an eager import here
would close a cycle."""

from depthvo_tpu_torch.train.state import TrainState, build_models, create_state  # noqa: F401

_LOOP_NAMES = ("make_train_step", "compute_losses", "fit")


def __getattr__(name):
    if name in _LOOP_NAMES:
        from depthvo_tpu_torch.train import loop

        return getattr(loop, name)
    raise AttributeError(f"module 'depthvo_tpu_torch.train' has no attribute {name!r}")
