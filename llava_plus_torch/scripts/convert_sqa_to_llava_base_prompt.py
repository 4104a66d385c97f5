"""ScienceQA prompt builders (the port's copy of scripts/convert_sqa_to_llava_base_prompt.py,
condensed to the QCM-LEA family actually used by the recipes)."""


def get_question_text(problem):
    return problem["question"]


def get_context_text(problem, use_caption=False):
    txt_context = problem["hint"]
    img_context = problem["caption"] if use_caption else ""
    context = " ".join([txt_context, img_context]).strip()
    return context if context else "N/A"


def get_choice_text(problem, options=("A", "B", "C", "D", "E")):
    choices = problem["choices"]
    choice_list = [
        f"({options[i]}) {c}" for i, c in enumerate(choices)
    ]
    return " ".join(choice_list)


def get_answer(problem, options=("A", "B", "C", "D", "E")):
    return options[problem["answer"]]


def get_lecture_text(problem):
    return problem["lecture"].replace("\n", "\\n")


def get_solution_text(problem):
    return problem["solution"].replace("\n", "\\n")


def create_one_example_chatbot(format, question, context, choice, answer,
                               lecture, solution, test_example=True):
    input_format, output_format = format.split("-")
    if input_format == "CQM":
        input = f"Context: {context}\nQuestion: {question}\nOptions: {choice}\n"
    elif input_format == "QCM":
        input = f"Question: {question}\nContext: {context}\nOptions: {choice}\n"
    elif input_format == "QM":
        input = f"Question: {question}\nOptions: {choice}\n"
    else:
        raise ValueError(f"unsupported input format {input_format}")

    if output_format == "A":
        output = f"The answer is {answer}."
    elif output_format == "AL":
        output = f"The answer is {answer}. BECAUSE: {solution}"
    elif output_format == "AE":
        output = f"The answer is {answer}. BECAUSE: {lecture}"
    elif output_format == "ALE":
        output = f"The answer is {answer}. BECAUSE: {lecture} {solution}"
    elif output_format == "LEA":
        output = f"{lecture} {solution} The answer is {answer}."
    elif output_format == "LA":
        output = f"{lecture} The answer is {answer}."
    elif output_format == "EA":
        output = f"{solution} The answer is {answer}."
    else:
        raise ValueError(f"unsupported output format {output_format}")

    input = input.replace("  ", " ").strip()
    output = output.replace("  ", " ").strip()
    if output.endswith("BECAUSE:"):
        output = output.replace("BECAUSE:", "").strip()
    return input, output


def build_prompt_chatbot(problems, shot_qids, prompt_format,
                         use_caption=False, options=("A", "B", "C", "D", "E"),
                         is_test=False):
    examples = {}
    for qid in shot_qids:
        question = get_question_text(problems[qid])
        context = get_context_text(problems[qid], use_caption)
        choice = get_choice_text(problems[qid], options)
        answer = get_answer(problems[qid], options)
        lecture = get_lecture_text(problems[qid]).replace("\\n", "\n")
        solution = get_solution_text(problems[qid]).replace("\\n", "\n")
        train_example = create_one_example_chatbot(
            prompt_format, question, context, choice, answer, lecture,
            solution, test_example=is_test,
        )
        examples[qid] = train_example
    return examples
