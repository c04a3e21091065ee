"""Parallel layer of the port: the data-parallel exchange over
``torch.distributed`` (``launch``, ``common``, ``replicated``), the attention
strategies over a sequence axis (``ring``), the LM trainer on a dp x sp
mesh of processes (``lm``), and the LM's model-axis families (``tp``,
``moe``, ``pp``) behind one front end (``model_axes``)."""
