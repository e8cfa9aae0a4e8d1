"""The plain reference: GLASS in f32 plain PyTorch, with no kernel of the
program, imported by nothing of the program and importing none of it."""
