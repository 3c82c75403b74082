"""The LM substrate of the port: the ``attn`` family's layers, attention
and decoder (``layers``, ``attention``, ``transformer``), the compute
policy, and ``convert`` from the reference's parameters."""
