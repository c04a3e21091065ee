"""Parallel layer of the port: the data-parallel exchange over
``torch.distributed`` (``launch``, ``common``, ``replicated``), the attention
strategies and the LM trainer (one device)."""
