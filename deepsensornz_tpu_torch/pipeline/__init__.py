"""Run reconstruction: a trained run's directory → model, loader, processor."""
