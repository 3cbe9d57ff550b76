"""Static checks of the port's lowering IR (``verify_ir``: the structural
invariants ``apply_rules`` checks after every rewrite)."""
