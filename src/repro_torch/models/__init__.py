"""Dense transformer assembly, PIM-backed projections and the plan compiler."""
