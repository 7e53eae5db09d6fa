from .weights import (densenet_state_dict_from_jax, dynunet_state_dict_from_jax, filter_state_dict_from_jax,
                      segresnet_state_dict_from_jax, swin_state_dict_from_jax, unet_state_dict_from_jax,
                      unetr_state_dict_from_jax, vit_state_dict_from_jax)
