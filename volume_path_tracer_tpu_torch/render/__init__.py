"""Render subpackage: integrator, renderer, waves, megakernel.

As in the JAX package, the top-level API exposes ``vpt.render(scene)`` while
``volume_path_tracer_tpu_torch.render`` stays importable as a package
(``import volume_path_tracer_tpu_torch.render.integrator`` and friends): the
subpackage itself is callable and forwards to :func:`renderer.render`.
"""
import sys
import types


class _CallableRenderModule(types.ModuleType):
    def __call__(self, *args, **kwargs):
        from .renderer import render

        return render(*args, **kwargs)

    @property
    def __signature__(self):
        # Keep inspect.signature(vpt.render) meaningful for tooling.
        import inspect

        from .renderer import render

        return inspect.signature(render)


sys.modules[__name__].__class__ = _CallableRenderModule
