"""Device ms a decode step: what the program's ``serve.decode_step`` spans
(``serve/engine.py`` ``Engine.generate``, one a step) launched in the
layered sub-window, over their number."""


def read(ctx, view):
    n = sum(1 for e in view.cpu if e.name == "serve.decode_step" and e.thread == view.main)
    return 1e3 * view.layer_s("serve.decode_step") / n if n else None
