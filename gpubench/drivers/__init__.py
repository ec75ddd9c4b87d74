"""One driver a traffic kind: ``run(ctx) -> harness.Outcome``."""
