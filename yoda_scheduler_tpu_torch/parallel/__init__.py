from .train import build_llama_train_step, init_opt_state, param_leaves

__all__ = ["build_llama_train_step", "init_opt_state", "param_leaves"]
