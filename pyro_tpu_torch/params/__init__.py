from .param_store import clear_param_store, get_param_store, param_store_from_jax, param_with_module_name

__all__ = ["clear_param_store", "get_param_store", "param_store_from_jax", "param_with_module_name"]
