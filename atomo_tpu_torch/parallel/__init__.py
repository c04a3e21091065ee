"""Parallel layer of the port: the data-parallel exchange over
``torch.distributed`` (``launch``, ``common``, ``replicated``), the attention
strategies over a sequence axis (``ring``) and the LM trainer on a dp x sp
mesh of processes (``lm``)."""
