"""decode_host_us_per_layer (us, model step): the port's own host time a decode step
takes per layer it ran.  The host time of the program's ``edgent:model.decode_step``
spans less that of the ``edgent:kernel.*`` spans inside them (the kernel wrappers,
with whatever wraps them), over the layers those steps ran, from the program's span
registry (``repro_torch.obs.spans``), which records while the traced window's profiler
runs.  None where the program has no such registry or it holds no decode step."""


def read(run):
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    reg = spans.REGISTRY
    if "model.decode_layers" not in reg or not reg.counter("model.decode_layers").value:
        return None
    own_ns = (reg.counter("model.decode_step.host_ns").value
              - reg.counter("model.decode_step.kernel_ns").value)
    return own_ns / 1e3 / reg.counter("model.decode_layers").value
