"""Model construction, the train, eval and infer steps, checkpoints and
the `Trainer`."""


def __getattr__(name):
    # imported on first use: `training.loop` imports the data pipeline,
    # which imports `training.state`
    if name == "Trainer":
        from monodepth_tpu_torch.training.loop import Trainer

        return Trainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
