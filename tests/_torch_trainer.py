"""Shared by the port's Trainer tests (``test_torch_trainer_*.py``): a tiny
MiT-B0 training config for either package and its synthetic datasets.
"""


def tiny_cfg(cls, out, epochs=1, **data):
    return cls.TrainConfig(
        model=cls.ModelConfig(backbone="mit_b0", head="segformerhead", num_classes=4,
                              compute_dtype="float32"),
        data=cls.DataConfig(dataset="synthetic", img_size=32, batch_size=8, val_batch_size=8,
                            num_workers=2, **data),
        optim=cls.OptimConfig(lr=3e-3, epochs=epochs, warmup_steps=2),
        output_dir=str(out), print_freq=1)


def tiny_datasets(cls):
    return cls(num_classes=4, size=32, length=16, seed=0), cls(num_classes=4, size=32, length=8,
                                                               seed=9)
