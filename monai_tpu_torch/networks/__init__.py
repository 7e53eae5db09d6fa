from .weights import unet_state_dict_from_jax
