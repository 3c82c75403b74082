"""The LM substrate of the port: the shared layers, attention, the MoE,
RWKV-6 and Mamba2 mixers, the decoder of every family (``layers``,
``attention``, ``moe``, ``rwkv``, ``ssm``, ``transformer``), the compute
policy, and ``convert`` from the reference's parameters."""
