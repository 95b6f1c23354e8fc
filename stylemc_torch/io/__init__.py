from .pickle_loader import (
    EasyDict,
    PersistentStub,
    load_network_pkl,
    generator_from_stub,
    load_generator,
)
from .native import load_native, save_native
from .torch_state import load_state_dict_numpy, strip_prefix
from .export import (ada_to_rosinality_state, encoder_to_torch_state,
                     save_rosinality_pt, save_e4e_pt)
from .tf_legacy import (TFNetworkStub, convert_tf_generator,
                        convert_tf_discriminator, discriminator_from_stub)

__all__ = [
    "EasyDict",
    "PersistentStub",
    "load_network_pkl",
    "generator_from_stub",
    "load_generator",
    "load_native",
    "save_native",
    "load_state_dict_numpy",
    "strip_prefix",
    "ada_to_rosinality_state",
    "encoder_to_torch_state",
    "save_rosinality_pt",
    "save_e4e_pt",
    "TFNetworkStub",
    "convert_tf_generator",
    "convert_tf_discriminator",
    "discriminator_from_stub",
]
