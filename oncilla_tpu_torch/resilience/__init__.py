"""Time budgets (:mod:`.timebudget`)."""
