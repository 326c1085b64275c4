"""Host-side utilities of the port: text encoders, evaluation metrics,
profiling, validation figures, mask helpers, and a parameter count."""


def num_params(module, print_out: bool = True, model_name: str = "model"):
    """Parameter count, frozen ones included as the JAX package counts its
    whole parameter tree (reference: utils/__init__.py:267-277
    print_arch/num_params)."""
    n = sum(p.numel() for p in module.parameters())
    if print_out:
        print(f"| {model_name} Trainable Parameters: {n / 1e6:.3f}M")
    return n


def tensors_to_np(d):
    """Tensors (any device) in a nested dict / list / tuple -> numpy
    (reference: utils tensors_to_np)."""
    if isinstance(d, dict):
        return {k: tensors_to_np(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return type(d)(tensors_to_np(v) for v in d)
    if hasattr(d, "detach"):
        return d.detach().cpu().numpy()
    return d
