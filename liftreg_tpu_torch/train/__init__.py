"""Training of the port: optimizers and schedules, the trainer and its
registry of names (``train.network_class``)."""
from .optim import PlateauLR, StepLR, build_optimizer  # noqa: F401
from .trainer import MetricsLogger, RegistrationTrainer, load_pca  # noqa: F401

# the JAX registry's names; the reference class path is an alias
NETWORK_REGISTRY = {
    "registration": RegistrationTrainer,
    "RegistrationTrainer": RegistrationTrainer,
    "liftreg.networks.RegistrationNet.RegistrationNet": RegistrationTrainer,
}


def get_network(name=None):
    """Resolve the trainer class named by ``train.network_class``;
    ``None``/unset falls back to :class:`RegistrationTrainer`."""
    if not name:
        return RegistrationTrainer
    if name in NETWORK_REGISTRY:
        return NETWORK_REGISTRY[name]
    raise KeyError(f"unknown network_class {name!r}; known: "
                   f"{sorted(NETWORK_REGISTRY)}")
