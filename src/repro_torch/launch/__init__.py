"""Launch entry points (``repro/launch``): the LM prefill step."""
