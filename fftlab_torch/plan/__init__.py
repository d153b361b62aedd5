"""Planning: routes, plans, flags and device capabilities."""
