"""RestorationPipeline and the classical fallbacks."""
