"""Context for MoE dispatch (``repro.models.moe_ctx``, its
``dispatch_groups`` only).

``dispatch_groups`` is the number of token groups the GShard dispatch of
``layers.moe_forward`` computes routing and capacity in when no
``groups=`` is passed: one per data shard in the JAX package's launchers.
The port runs on one card, so it stays 1 unless a caller sets it. The JAX
package's sharding hints (``dispatch_spec``, ``mla_q_spec``) belong to a
device mesh, which the port does not have yet.
"""
import contextvars

dispatch_groups = contextvars.ContextVar("moe_dispatch_groups", default=1)
